"""Carry state across from the JAX package.

The system has no trained weights: the state a model holds is its line
tile tensors and isotope tables (``fast_device_arrays``, per band
``banded_device_arrays``) in fast mode, and in exact mode its line plan,
profile table and their device arrays.  This turns that state, as numpy
arrays (for example ``{k: np.asarray(v)}`` of transit_tpu's
``model.fdev``), into the port's, so both packages can be fed identical
state.
"""

from __future__ import annotations

import numpy as np
import torch

from transit_tpu_torch.opacities.lbl import LinePlan, scatter_tiles
from transit_tpu_torch.opacities.voigt import ProfileTable

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


# Exact mode's device arrays: the bool masks and the float32 profile
# table; the other integer arrays become int32, the rest floats.
_EXACT_BOOL = ("line_inrange", "g_inrange")


def exact_state_from_numpy(plan: dict, table: dict, dev: dict,
                           dtype=torch.float64, device="cuda"):
    """JAX's exact-mode state as numpy -> the port's (LinePlan,
    ProfileTable, device-array dict on ``device``).  ``plan`` and
    ``table``: ``dataclasses.asdict`` of transit_tpu's LinePlan and
    ProfileTable; ``dev``: its ``device_arrays`` dict as numpy.  The dict
    gets the port's int32 indices, floats in ``dtype``, the float32
    table, and the port's extra keys ``g_iso``, ``g_wavn`` and
    ``g_tiles`` (lbl.device_arrays)."""
    out = {}
    for k, v in dev.items():
        v = np.asarray(v)
        if k in _EXACT_BOOL:
            out[k] = torch.as_tensor(v.astype(bool), device=device)
        elif k == "profflat":
            out[k] = torch.as_tensor(v.astype(np.float32), device=device)
        elif v.dtype.kind in "iu":
            if v.size and (v.min() < -2 ** 31 or v.max() >= 2 ** 31):
                raise ValueError(f"{k} does not fit int32")
            out[k] = torch.as_tensor(v.astype(np.int32), device=device)
        else:
            out[k] = torch.tensor(v, dtype=dtype, device=device)
    prim = out["g_primary"].long()
    out["g_iso"] = out["line_iso"][prim]
    out["g_wavn"] = out["wavn"][prim]
    out["g_tiles"] = torch.as_tensor(scatter_tiles(out["g_iso"].cpu()),
                                     device=device)
    return LinePlan(**plan), ProfileTable(**table), out
