"""Native host preprocessing of line lists — the counterpart of
transit_tpu._native (native/lineprep.cpp).

The port's own copy of the three routines, ``csrc/lineprep.cpp``, built
with the host C++ compiler at first use and called through ctypes
(:func:`transit_tpu_torch.opacities._build.load_host_library`).  They
serve set-up on every device: exact mode's co-add partition
(``opacities.lbl.plan_lines``), the TLI line order
(``lineread.compile.sort_iso_wl``) and the HITRAN float columns
(``lineread.hitran._parse_float``).  Each takes and returns numpy arrays
and gives, bit for bit, what its plain Python version beside its caller
gives.  A failed build raises; nothing falls back to Python.
"""

from __future__ import annotations

import numpy as np

from transit_tpu_torch.opacities import _build


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def group_partition(wavn, isoid, owns, wn_i: float, odwn: float,
                    dwn: float, wn_top: float):
    """The co-add group partition of the sorted lines (lbl.py:80-98):
    (gid int32 (n,), primary int32 (ng,), inrange bool (ng,), iown int64
    (ng,), idwn int64 (ng,))."""
    wavn = np.ascontiguousarray(wavn, dtype=np.float64)
    isoid = np.ascontiguousarray(isoid, dtype=np.int32)
    owns = np.ascontiguousarray(owns, dtype=np.float64)
    n = wavn.shape[0]
    if isoid.shape != (n,) or wavn.ndim != 1 or owns.ndim != 1:
        raise ValueError(f"group_partition: wavn {wavn.shape}, isoid "
                         f"{isoid.shape}, owns {owns.shape}")
    if n and owns.shape[0] == 0:
        raise ValueError("group_partition: empty oversampled grid")
    gid = np.empty(n, np.int32)
    primary = np.empty(n, np.int32)
    inrange = np.empty(n, np.uint8)
    iown = np.empty(n, np.int64)
    idwn = np.empty(n, np.int64)
    ng = _build.load_host_library().group_partition(
        _ptr(wavn), _ptr(isoid), n, _ptr(owns), owns.shape[0], float(wn_i),
        float(odwn), float(dwn), float(wn_top), _ptr(gid), _ptr(primary),
        _ptr(inrange), _ptr(iown), _ptr(idwn))
    return (gid, primary[:ng].copy(), inrange[:ng].astype(bool),
            iown[:ng].copy(), idwn[:ng].copy())


def argsort_iso_wl(isoid, wl) -> np.ndarray:
    """The stable argsort by (isotope, wavelength), int64 (n,):
    np.lexsort((wl, isoid)) on the int32 isotopes and float64
    wavelengths (-0.0 equal to +0.0, NaN last, ties in input order)."""
    iso32 = np.ascontiguousarray(isoid, dtype=np.int32)
    wl64 = np.ascontiguousarray(wl, dtype=np.float64)
    n = wl64.shape[0]
    if iso32.shape != (n,) or wl64.ndim != 1:
        raise ValueError(f"argsort_iso_wl: isoid {iso32.shape}, wl "
                         f"{wl64.shape}")
    out = np.empty(n, np.int64)
    if _build.load_host_library().argsort_iso_wl(_ptr(iso32), _ptr(wl64), n,
                                                 _ptr(out)):
        raise ValueError("argsort_iso_wl: isoid range too large (> 2^22)")
    return out


def parse_fixed_floats(data: bytes, recsize: int, offset: int, width: int,
                       n: int) -> np.ndarray:
    """float64 (n,): field k is bytes [k * recsize + offset, + width) of
    ``data`` (at most 63 read), parsed as C's strtod in the C locale
    parses it (leading blanks skipped, the parse ending at the first byte
    that is not part of a number, a blank field 0.0)."""
    buf = np.frombuffer(data, dtype=np.uint8)
    out = np.empty(max(n, 0), np.float64)
    rc = _build.load_host_library().parse_fixed_floats(
        _ptr(buf), buf.shape[0], recsize, offset, width, n, _ptr(out))
    if rc == 1:
        raise ValueError(f"parse_fixed_floats: {n} records of {recsize} "
                         f"bytes (field {offset}:+{width}) overrun "
                         f"{buf.shape[0]} bytes")
    if rc:
        raise RuntimeError("parse_fixed_floats: no C locale")
    return out
