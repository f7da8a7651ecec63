"""Carry state across from the JAX package.

The system has no trained weights: the state a model holds is its line
tile tensors and isotope tables (``fast_device_arrays``, per band
``banded_device_arrays``).  This turns
that dict, as numpy arrays (for example ``{k: np.asarray(v)}`` of
transit_tpu's ``model.fdev``), into the port's tensors, so both packages
can be fed identical state.
"""

from __future__ import annotations

import numpy as np
import torch

_INT_KEYS = ("iso", "iso_imol", "all_iso")


def device_arrays_from_numpy(d, dtype=torch.float32, device="cuda"):
    """numpy ``fast_device_arrays`` dict -> dict of tensors on ``device``:
    float arrays in ``dtype``, isotope indices int32, the mask bool.  A
    ``"classes"`` list (tile classes) and a ``"far"`` list of
    (dict | None, dict | None) shells convert entry by entry, and a list
    (``banded_device_arrays``) band by band."""
    if isinstance(d, (list, tuple)):
        return [device_arrays_from_numpy(b, dtype, device) for b in d]
    out = {}
    for k, v in d.items():
        if k == "classes":
            out[k] = [device_arrays_from_numpy(c, dtype, device) for c in v]
            continue
        if k == "far":
            out[k] = [tuple(None if p is None else
                            device_arrays_from_numpy(p, dtype, device)
                            for p in shell) for shell in v]
            continue
        if k == "mask":
            dt = torch.bool
        elif k in _INT_KEYS:
            dt = torch.int32
        else:
            dt = dtype
        out[k] = torch.tensor(np.asarray(v), dtype=dt, device=device)
    return out
