"""Nearest-index search matching the reference's binsearchapprox.

Reference: pu/src/iomisc.c:1089-1108.  The C routine recursively bisects
[lo, hi] and at the end returns whichever of the two bracketing indices is
*strictly* closer to the value (ties -> lower index).  For an ascending array
this is equivalent to a nearest-neighbour search, which we express with
searchsorted so it vectorizes.
"""

from __future__ import annotations

import numpy as np
import torch


def nearest_index_np(arr: np.ndarray, value) -> np.ndarray:
    """Index of the element of ascending ``arr`` nearest to ``value``.

    Ties resolve to the lower index (|arr[hi]-v| < |arr[lo]-v| required to
    pick hi, iomisc.c:1093-1096).  Works elementwise for array ``value``.
    """
    arr = np.asarray(arr)
    value = np.asarray(value)
    n = arr.shape[0]
    hi = np.clip(np.searchsorted(arr, value, side="left"), 1, n - 1)
    lo = hi - 1
    pick_hi = np.abs(arr[hi] - value) < np.abs(arr[lo] - value)
    return np.where(pick_hi, hi, lo)


def nearest_index_torch(arr: torch.Tensor, value: torch.Tensor):
    """Tensor version of :func:`nearest_index_np`."""
    n = arr.shape[0]
    hi = torch.searchsorted(arr, value.contiguous(), side="left")
    hi = hi.clamp(1, n - 1)
    lo = hi - 1
    pick_hi = (arr[hi] - value).abs() < (arr[lo] - value).abs()
    return torch.where(pick_hi, hi, lo)
