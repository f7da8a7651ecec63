"""Non-uniform Simpson integration expressed as weight vectors.

The reference integrates over non-uniform grids with a Simpson scheme built
from interval pair coefficients (reference: pu/src/numerical.c:390-525,
``geth``/``simps``/``simpson``).  The integral is a *linear* functional of the
sampled values, so we precompute the weight vector w with
``integral = w @ y`` and every path/level integral becomes a dot product or a
matmul.

Semantics reproduced exactly:
  * n == 1 -> 0
  * n == 2 -> trapezoid:  h0*(y0+y1)/2
  * n >= 3 -> pairwise Simpson over intervals; when the number of samples is
    even the first interval is handled by a trapezoid and the Simpson pairs
    start at index 1 (numerical.c:413-424,472-480).
"""

from __future__ import annotations

import numpy as np
import torch


def simpson_weights_np(x: np.ndarray) -> np.ndarray:
    """Weight vector w such that w @ y == simps(y) of the reference."""
    x = np.asarray(x, dtype=np.float64)
    n = x.shape[0]
    w = np.zeros(n, dtype=np.float64)
    if n < 2:
        return w
    h = np.diff(x)
    if n == 2:
        w[0] = w[1] = h[0] / 2.0
        return w
    even = int(n % 2 == 0)
    # Simpson pairs: j = 2*i + even, i in [0, (n-1)//2)
    npairs = (n - 1) // 2
    i = np.arange(npairs)
    j = 2 * i + even
    h0 = h[j]
    h1 = h[j + 1]
    hsum = h0 + h1
    hratio = h1 / h0
    hfactor = hsum * hsum / (h0 * h1)
    np.add.at(w, j, (2.0 - hratio) * hsum / 6.0)
    np.add.at(w, j + 1, hfactor * hsum / 6.0)
    np.add.at(w, j + 2, (2.0 - 1.0 / hratio) * hsum / 6.0)
    if even:
        w[0] += h[0] / 2.0
        w[1] += h[0] / 2.0
    return w


def suffix_simpson_matrix_np(x: np.ndarray) -> np.ndarray:
    """Matrix W with W[s] = Simpson weights of the suffix x[s:] placed at
    global indices (zeros before s).  Used for per-height vertical optical
    depth: tau[s] = W[s] @ y (reference: transit/src/eclipse.c:28-105)."""
    x = np.asarray(x, dtype=np.float64)
    n = x.shape[0]
    W = np.zeros((n, n), dtype=np.float64)
    for s in range(n):
        W[s, s:] = simpson_weights_np(x[s:])
    return W


def trapz_np(x: np.ndarray, y: np.ndarray) -> float:
    """Reference integ_trapz (numerical.c:155-172)."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    return 0.5 * float(np.sum((x[1:] - x[:-1]) * (y[1:] + y[:-1])))


def simpson_weights_torch(x: torch.Tensor, n_valid=None) -> torch.Tensor:
    """Tensor version of :func:`simpson_weights_np` with a prefix mask
    (the counterpart of transit_tpu's simpson_weights_jnp), batched over
    the leading dimensions of ``x`` (..., n).

    Only the first ``n_valid`` entries of each row are meaningful
    (``n_valid``: an int, or an integer tensor of the leading shape, so
    that every row has its own count); the weights beyond are zero.
    Differentiable in ``x``: the guards on h0, h1 and their ratio keep
    the masked pairs' terms finite, so their zero factor zeroes their
    gradient too."""
    n = x.shape[-1]
    lead = x.shape[:-1]
    if n_valid is None:
        n_valid = n
    if isinstance(n_valid, torch.Tensor):
        n_valid = n_valid.to(device=x.device, dtype=torch.long).expand(lead)
    else:       # a fill on x's device: no tensor from host data
        n_valid = torch.full(lead, int(n_valid), dtype=torch.long,
                             device=x.device)
    h = x[..., 1:] - x[..., :-1]                      # (..., n-1)
    even = (n_valid % 2 == 0).long()
    npairs_valid = torch.div(n_valid - 1, 2, rounding_mode="floor")
    i = torch.arange((n - 1) // 2 + 1, device=x.device)
    j = 2 * i + even[..., None]
    pair_ok = i < npairs_valid[..., None]
    jc = j.clamp(0, n - 3)
    h0 = torch.gather(h, -1, jc)
    h1 = torch.gather(h, -1, jc + 1)
    one = torch.ones((), dtype=x.dtype, device=x.device)
    safe_h0 = torch.where(h0 == 0, one, h0)
    safe_h1 = torch.where(h1 == 0, one, h1)
    hsum = h0 + h1
    hratio = h1 / safe_h0
    safe_hratio = torch.where(hratio == 0, one, hratio)
    hfactor = hsum * hsum / (safe_h0 * safe_h1)

    z = pair_ok.to(x.dtype)
    w = torch.zeros(lead + (n,), dtype=x.dtype, device=x.device)
    w = w.scatter_add(-1, jc, z * (2.0 - hratio) * hsum / 6.0)
    w = w.scatter_add(-1, jc + 1, z * hfactor * hsum / 6.0)
    w = w.scatter_add(-1, jc + 2, z * (2.0 - 1.0 / safe_hratio) * hsum / 6.0)

    # n == 2 and the even count's first-interval trapezoid:
    trap = torch.where((n_valid == 2) | ((n_valid > 2) & (even == 1)),
                       h[..., 0] / 2.0, 0 * one)
    w = torch.cat([w[..., :2] + trap[..., None], w[..., 2:]], dim=-1)
    return torch.where((n_valid < 2)[..., None], 0 * one, w)
