"""Natural cubic spline matching the reference implementation.

Reference: pu/src/spline.c.  The C code solves the natural-spline tridiagonal
system with the Kincaid & Cheney elimination (spline.c:12-48, ``tri``) and
evaluates with the nested-polynomial form of splinterp_pt (spline.c:131-183).

The numpy path is used for host-side precomputation.  The torch path
evaluates splines on tensors whose ordinates change every step (partition
functions and CIA tables at the layer temperatures).  Its abscissae are
always static tables, so the second derivatives of a torch spline are one
matrix product with the precomputed inverse of the tridiagonal system
(:func:`spline_operator_np`) instead of a sequential scan.
"""

from __future__ import annotations

import numpy as np
import torch

from transit_tpu_torch.numerics.search import (nearest_index_np,
                                               nearest_index_torch)


# ----------------------------------------------------------------------------
# numpy (host) path
# ----------------------------------------------------------------------------

def spline_second_derivs_np(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Second derivatives z of the natural cubic spline (spline.c tri())."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    n = x.shape[0]
    z = np.zeros(n, dtype=np.float64)
    if n < 3:
        return z
    h = np.diff(x)
    b = np.diff(y) / h
    u = np.zeros(n - 1)
    v = np.zeros(n - 1)
    u[1] = 2.0 * (h[1] + h[0])
    v[1] = 6.0 * (b[1] - b[0])
    for i in range(2, n - 1):
        u[i] = 2.0 * (h[i] + h[i - 1]) - h[i - 1] * h[i - 1] / u[i - 1]
        v[i] = 6.0 * (b[i] - b[i - 1]) - v[i - 1] * h[i - 1] / u[i - 1]
    for i in range(n - 2, 0, -1):
        z[i] = (v[i] - h[i] * z[i + 1]) / u[i]
    return z


def spline_operator_np(x: np.ndarray) -> np.ndarray:
    """Matrix A (n-2, n-2) with z[1:-1] = A @ d for the natural spline on
    abscissae x, where d[i-1] = 6 (b[i] - b[i-1]) and b = diff(y)/diff(x):
    the inverse of the spline's tridiagonal system, from the elimination
    of :func:`spline_second_derivs_np` run on unit right-hand sides.

    Applying it to the divided differences d, and not to y itself, keeps
    the cancellation where the elimination has it: the operator on y
    would cancel a constant offset of y only to roundoff of |A||y|."""
    x = np.asarray(x, dtype=np.float64)
    n = x.shape[0]
    if n < 3:
        return np.zeros((0, 0))
    m = n - 2
    eye = np.eye(m)
    h = np.diff(x)
    u = np.zeros(n - 1)
    v = np.zeros((n - 1, m))
    u[1] = 2.0 * (h[1] + h[0])
    v[1] = eye[0]
    for i in range(2, n - 1):
        u[i] = 2.0 * (h[i] + h[i - 1]) - h[i - 1] * h[i - 1] / u[i - 1]
        v[i] = eye[i - 1] - v[i - 1] * h[i - 1] / u[i - 1]
    z = np.zeros((n, m))
    for i in range(n - 2, 0, -1):
        z[i] = (v[i] - h[i] * z[i + 1]) / u[i]
    return z[1:-1]


def spline_eval_np(x: np.ndarray, y: np.ndarray, z: np.ndarray, xout):
    """Evaluate the spline at xout (vectorized splinterp_pt, spline.c:131-183)."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    xout = np.asarray(xout, dtype=np.float64)
    n = x.shape[0]
    idx = nearest_index_np(x, xout)
    # Enforce x[i] <= xout (except when idx would underflow):
    idx = np.where((idx == n - 1) | (xout < x[idx]), idx - 1, idx)
    idx = np.clip(idx, 0, n - 2)
    x_lo = x[idx]
    h = x[idx + 1] - x_lo
    dy = y[idx + 1] - y[idx]
    dx = xout - x_lo
    a = (z[idx + 1] - z[idx]) / (6.0 * h)
    b = 0.5 * z[idx]
    c = dy / h - h / 6.0 * (z[idx + 1] + 2.0 * z[idx])
    out = y[idx] + dx * (c + dx * (b + dx * a))
    # Exact hit fast-path of the C code (splinterp_pt:169-170):
    exact = x[np.clip(idx, 0, n - 1)] == xout
    out = np.where(exact, y[idx], out)
    return out


def splinterp_np(x, y, xout):
    """Natural-spline interpolation y(xout) from samples (x, y)."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    if x.shape[0] < 3:
        # Degenerate: fall back to linear interpolation.
        return np.interp(np.asarray(xout, dtype=np.float64), x, y)
    z = spline_second_derivs_np(x, y)
    return spline_eval_np(x, y, z, xout)


# ----------------------------------------------------------------------------
# torch (device) path
# ----------------------------------------------------------------------------

def spline_second_derivs_torch(x: torch.Tensor, y: torch.Tensor,
                               A: torch.Tensor):
    """Second derivatives of the natural spline through (x, y), y (n, ...)
    (the counterpart of spline_second_derivs_jnp).  ``A`` is
    spline_operator_np(x): the sequential elimination becomes one matrix
    product, since x is a static table."""
    n = y.shape[0]
    if n < 3:
        return torch.zeros_like(y)
    h = (x[1:] - x[:-1]).reshape((-1,) + (1,) * (y.ndim - 1))
    b = (y[1:] - y[:-1]) / h
    d = 6.0 * (b[1:] - b[:-1])                       # (n-2, ...)
    zmid = (A @ d.reshape(n - 2, -1)).reshape(d.shape)
    zero = torch.zeros_like(y[:1])
    return torch.cat([zero, zmid, zero])


def spline_eval_torch(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor,
                      xout: torch.Tensor):
    """Evaluate the spline through (x, y) with second derivatives z at
    ``xout`` (m,).  y and z are (n, ...); the result is (m, ...)
    (the counterpart of spline_eval_jnp)."""
    n = x.shape[0]
    idx = nearest_index_torch(x, xout)
    idx = torch.where((idx == n - 1) | (xout < x[idx]), idx - 1, idx)
    idx = idx.clamp(0, n - 2)
    bshape = (-1,) + (1,) * (y.ndim - 1)
    x_lo = x[idx]
    h = (x[idx + 1] - x_lo).reshape(bshape)
    dx = (xout - x_lo).reshape(bshape)
    y0, y1 = y[idx], y[idx + 1]
    z0, z1 = z[idx], z[idx + 1]
    a = (z1 - z0) / (6.0 * h)
    b = 0.5 * z0
    c = (y1 - y0) / h - h / 6.0 * (z1 + 2.0 * z0)
    out = y0 + dx * (c + dx * (b + dx * a))
    exact = (x[idx] == xout).reshape(bshape)
    return torch.where(exact, y0, out)
