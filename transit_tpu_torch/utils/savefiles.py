"""Extinction checkpoint file ('saveext').

Reference: transit/src/extinction.c:62-137 (savefile_extinct /
restfile_extinct); a copy of transit_tpu.utils.savefiles (numpy only).
Binary layout: 5-byte magic "@E@S@", then the (nrad x nwn) float64
extinction array, then nrad computed-flags as int16 (the reference
redefines _Bool as short, transit.h:129).  Valid for reuse when only the
radius scale changes (doc/changelog:28-30).
"""

from __future__ import annotations

import os

import numpy as np

MAGIC = b"@E@S@"


def save_extinction(path: str, ext: np.ndarray, computed=None):
    ext = np.asarray(ext, dtype="<f8")
    nrad = ext.shape[0]
    if computed is None:
        computed = np.ones(nrad, dtype="<i2")
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(ext.tobytes())
        f.write(np.asarray(computed, dtype="<i2").tobytes())


def load_extinction(path: str, nrad: int, nwn: int):
    """Returns (ext, computed) or None if the file is absent/invalid
    (the reference warns and continues, extinction.c:105-122)."""
    if not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        raw = f.read()
    if raw[:5] != MAGIC:
        return None
    need = 5 + nrad * nwn * 8 + nrad * 2
    if len(raw) < need:
        return None
    ext = np.frombuffer(raw, "<f8", nrad * nwn, 5).reshape(nrad, nwn).copy()
    computed = np.frombuffer(raw, "<i2", nrad, 5 + nrad * nwn * 8).copy()
    return ext, computed.astype(bool)
