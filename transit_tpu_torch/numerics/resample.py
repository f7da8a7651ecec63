"""Area-conserving integer-factor resampling (numpy; a copy of
transit_tpu.numerics.resample).

Reference: pu/src/numerical.c:279-364 (resample/downsample).  ``downsample``
collapses an oversampled array by factor f with half-weighted boundary
points so the integral is (nearly) conserved — the reference's mechanism
for collapsing fine spectra onto the output grid.
"""

from __future__ import annotations

import numpy as np


def resample(inp: np.ndarray, scale: int) -> np.ndarray:
    """Strided pick (numerical.c:281-293)."""
    return np.asarray(inp)[::scale].copy()


def downsample(inp: np.ndarray, scale: int) -> np.ndarray:
    """Area-conserving downsample by integer factor (numerical.c:296-364)."""
    inp = np.asarray(inp, dtype=np.float64)
    n = inp.shape[0]
    m = 1 + (n - 1) // scale
    ks = 2 * (scale // 2) + 1
    even = scale % 2 == 0
    out = np.zeros(m)

    out[0] = inp[:ks // 2 + 1].sum()
    if even:
        out[0] -= 0.5 * inp[ks // 2]
    out[0] /= 0.5 * (scale + 1)

    for j in range(1, m - 1):
        c = scale * j
        out[j] = inp[c - ks // 2:c + ks // 2 + 1].sum()
        if even:
            out[j] -= 0.5 * (inp[c - ks // 2] + inp[c + ks // 2])
        out[j] /= scale
    if m > 1:
        out[m - 1] = inp[n - 1 - ks // 2:].sum()
        if even:
            out[m - 1] -= 0.5 * inp[n - ks // 2]
        out[m - 1] /= 0.5 * (scale + 1)
    return out
