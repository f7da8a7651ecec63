"""Differentiable path-weight construction and hydrostatic radii.

The counterpart of transit_tpu.rt.geometry.  For retrieval the radius
grid changes every step (hydrostatic equilibrium from the new T/q
profiles; reference: transit/src/readatm.c:722-865 reloadatm/radpress),
so the path-weight matrices of rt/tau.py are rebuilt per step from
tensors.  Which layers each ray reaches is static (the impact parameters
are the reversed radius grid), so every row is built at once: the
per-row index pattern is a table made once per (n, device), the rows are
gathers, masks and one masked Simpson weight function over all rows.
Every constant tensor a step reads (the index tables, the parabola's
basis rows, the pressures) is made once per size, dtype and device and
kept, so that a step copies nothing from the host.

Every function takes radii of shape (..., n) and batches over the
leading dimensions (forward_batch builds every member's geometry in one
call).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from transit_tpu_torch.constants import AMU, KB
from transit_tpu_torch.numerics.simpson import simpson_weights_torch


def _parab_coeffs_torch(x3, xr):
    """Coefficients c with p(xr) = c @ y3, interp_parab
    (numerical.c:182-195).  x3: (..., 3), xr: (...); returns (..., 3)."""
    dx = x3[..., 1] - x3[..., 0]
    x0 = x3[..., 0] / dx
    # Basis y = e_k: my_k = [1, -2, 1]
    # b_k = ([0,-1,1][k] - (x0+1.5)*my_k)/dx
    # c_k = [1,0,0][k] + x0*([3,-4,1][k] + x0*my_k)/2
    my, b1, c1, e0 = _basis(x3.dtype, x3.device)[:4]
    a = my / (2.0 * dx * dx)[..., None]
    b = (b1 - (x0 + 1.5)[..., None] * my) / dx[..., None]
    c = e0 + x0[..., None] * (c1 + x0[..., None] * my) / 2.0
    return (xr * xr)[..., None] * a + xr[..., None] * b + c


@functools.lru_cache(maxsize=None)
def _basis(dtype, device):
    """The constant rows of the parabola's coefficients and of the
    weights' assembly, (3,) each in ``dtype`` on ``device``: my, b1, c1,
    e0 of :func:`_parab_coeffs_torch`, then half and last of row 1
    (:func:`_weights_rows`)."""
    return tuple(torch.tensor(v, dtype=dtype, device=device)
                 for v in ([1.0, -2.0, 1.0], [0.0, -1.0, 1.0],
                           [3.0, -4.0, 1.0], [1.0, 0.0, 0.0],
                           [0.0, 0.0, 0.5], [0.0, 0.0, 1.0]))


@functools.lru_cache(maxsize=None)
def _row_tables(n: int, device):
    """Tables of the general rows ri = 2..n-1 (segment start rs =
    n-1-ri, nseg = ri+1 samples), as tensors on ``device``: rs (R,),
    nseg (R,), idx (R, n) = clip(rs + k, 0, n-1), the layer of path
    sample k, src (R, n) = j - rs clipped at 0 with its mask live = j >=
    rs, which places sample j - rs at layer j, and rs3 (R, 3) = rs + (0,
    1, 2), the parabola's three layers."""
    ri = np.arange(2, n)
    rs = n - 1 - ri
    k = np.arange(n)
    idx = np.clip(rs[:, None] + k[None, :], 0, n - 1)
    src = k[None, :] - rs[:, None]
    return tuple(torch.as_tensor(a, device=device) for a in (
        rs, ri + 1, idx, np.maximum(src, 0), src >= 0,
        rs[:, None] + np.arange(3)))


def _weights_rows(rad, s_rows, s3):
    """The rows of W for every geometry (transit_tpu rt/geometry.py:43-85).

    rad (..., n); s_rows (..., n-2, n): the path coordinate of sample k
    of general row ri = 2..n-1 (layer idx[ri, k]); s3 (..., 3): row 1's
    path coordinates at rad[n-2], the midpoint and rad[n-1].  Returns
    W (..., n, n) on layers; row 0 is zero."""
    n = rad.shape[-1]
    dev, dt = rad.device, rad.dtype
    rs, nseg, _, src, live, rs3 = _row_tables(n, dev)
    _, _, _, e0, half, last = _basis(dt, dev)
    lead = rad.shape[:-1]
    R = n - 2
    w = simpson_weights_torch(s_rows, nseg.expand(lead + (R,)))
    # p over (rs, rs+1, rs+2) at rad[rs] replaces the first sample:
    p = _parab_coeffs_torch(rad[..., rs3], rad[..., rs])       # (..., R, 3)
    corr3 = w[..., :1] * (p - e0)
    # Sample k of the row lands at layer rs + k; the correction at rs..rs+2:
    zero = torch.zeros((), dtype=dt, device=dev)
    row = torch.where(live, torch.gather(w, -1, src.expand(lead + (R, n))),
                      zero)
    corr = torch.zeros(lead + (R, n), dtype=dt, device=dev).scatter(
        -1, rs3.expand(lead + (R, 3)), corr3)
    Wg = row + corr

    # Row ri = 1 (two layers left: parabola over n-3..n-1 + midpoint,
    # slantpath.c:62-74 / eclipse.c:68-80): its three columns n-3..n-1.
    p1 = _parab_coeffs_torch(rad[..., n - 3:], rad[..., n - 2])  # (..., 3)
    w3 = simpson_weights_torch(s3)
    C = torch.stack([p1, p1 / 2.0 + half, last.expand(p1.shape)], dim=-2)
    W1 = torch.cat([torch.zeros(lead + (n - 3,), dtype=dt, device=dev),
                    (w3[..., None, :] @ C)[..., 0, :]], dim=-1)
    W0 = torch.zeros(lead + (n,), dtype=dt, device=dev)
    return torch.cat([W0[..., None, :], W1[..., None, :], Wg], dim=-2)


def eclipse_weights_torch(rad):
    """Differentiable eclipse_weights (rt/tau.py) for radii (..., n)."""
    n = rad.shape[-1]
    rs, _, idx = _row_tables(n, rad.device)[:3]
    cs = torch.cat([torch.zeros_like(rad[..., :1]),
                    torch.cumsum(rad[..., 1:] - rad[..., :-1], dim=-1)],
                   dim=-1)
    s_rows = cs[..., idx] - cs[..., rs][..., None]
    r_s, r_n = rad[..., n - 2], rad[..., n - 1]
    mid = (r_s + r_n) / 2.0
    s3 = torch.stack([r_s - r_s, mid - r_s, r_n - r_s], dim=-1)
    return _weights_rows(rad, s_rows, s3)


def _safe_sqrt(arg):
    """sqrt with a finite gradient at 0: the tangent point gives arg == 0
    exactly, so the operand is masked before the sqrt."""
    pos = arg > 0.0
    one = torch.ones((), dtype=arg.dtype, device=arg.device)
    return torch.where(pos, torch.sqrt(torch.where(pos, arg, one)),
                       0 * one)


def transit_weights_torch(rad):
    """Differentiable transit_weights for impact parameters b = reversed
    radii, radii (..., n)."""
    n = rad.shape[-1]
    rs, _, idx = _row_tables(n, rad.device)[:3]
    r0 = rad[..., rs][..., None]
    s_rows = _safe_sqrt(rad[..., idx] ** 2 - r0 * r0)
    r_s, r_n = rad[..., n - 2], rad[..., n - 1]
    mid = (r_s + r_n) / 2.0
    s3 = _safe_sqrt(torch.stack([r_s, mid, r_n], dim=-1) ** 2 -
                    (r_s * r_s)[..., None])
    return 2.0 * _weights_rows(rad, s_rows, s3)


@functools.lru_cache(maxsize=None)
def _log_ratios(pressure: tuple, dtype, device):
    """c_k = kb/amu log(p_k / p_{k+1}), k = 0..nl-2, of the static
    pressures in ``dtype`` on ``device`` (:func:`radpress_torch`)."""
    p_t = torch.as_tensor(pressure, dtype=dtype, device=device)
    return KB / AMU * torch.log(p_t[:-1] / p_t[1:])


def radpress_torch(g0, p0, r0, temp, mu, pressure, rfct):
    """Hydrostatic radius grid (readatm.c:787-865 radpress; transit_tpu
    rt/geometry.py:127-190).

    pressure: static (nl,) host array in the atmosphere file's units;
    temp and mu (..., nl) tensors; returns radii (..., nl) in the file's
    units (divided by rfct).  The reference layer i0 is resolved on the
    host.  The per-layer factors, which do not depend on the radius,
    are computed for all layers at once; only the two recurrences
    r_new = r_prev -+ A_i * (c_i / g) / rfct and g_new = g (r_prev /
    r_new)^2 run layer by layer, each product associated as the JAX
    package associates it."""
    pressure = np.asarray(pressure, dtype=np.float64)
    nl = pressure.shape[0]
    i0 = int(np.argmin(np.abs(pressure - p0)))
    dt, dev = temp.dtype, temp.device
    kb_amu = KB / AMU
    g0, p0, r0, rfct = float(g0), float(p0), float(r0), float(rfct)

    t_i, mu_i = temp[..., i0], mu[..., i0]
    if pressure[i0] > p0:
        lr = float(np.log(pressure[i0 + 1] / pressure[i0]))
        L = float(np.log(p0 / pressure[i0]))
        temp0 = t_i + (temp[..., i0 + 1] - t_i) / lr * L
        mu0 = mu_i + (mu[..., i0 + 1] - mu_i) / lr * L
        rad_i0 = r0 + 0.5 * (t_i / mu_i + temp0 / mu0) * (
            kb_amu * L / g0) / rfct
    else:
        lr = float(np.log(pressure[i0 - 1] / pressure[i0]))
        L = float(np.log(p0 / pressure[i0]))
        temp0 = t_i + (temp[..., i0 - 1] - t_i) / lr * L
        mu0 = mu_i + (mu[..., i0 - 1] - mu_i) / lr * L
        rad_i0 = r0 - 0.5 * (t_i / mu_i + temp0 / mu0) * (
            kb_amu * float(np.log(pressure[i0] / p0)) / g0) / rfct
    g_start = g0 * (torch.full_like(rad_i0, r0) / rad_i0) ** 2

    # A_k = 0.5 ((T/mu)_k + (T/mu)_{k+1}) and c_k = kb/amu log(p_k/p_{k+1})
    # for the layer pairs (k, k+1), k = 0..nl-2, in the model's dtype:
    tm = temp / mu
    A = 0.5 * (tm[..., :-1] + tm[..., 1:])
    c = _log_ratios(tuple(pressure.tolist()), dt, dev)

    # Downward from i0-1 to 0 (readatm.c:837-842), then upward from i0+1
    # to nl-1 (readatm.c:847-851):
    down = []
    r, g = rad_i0, g_start
    for i in range(i0 - 1, -1, -1):
        r_new = r - A[..., i] * (c[i] / g) / rfct
        g = g * (r / r_new) ** 2
        r = r_new
        down.append(r)
    up = []
    r, g = rad_i0, g_start
    for i in range(i0 + 1, nl):
        r_new = r + A[..., i - 1] * (c[i - 1] / g) / rfct
        g = g * (r / r_new) ** 2
        r = r_new
        up.append(r)
    return torch.stack(down[::-1] + [rad_i0] + up, dim=-1)
