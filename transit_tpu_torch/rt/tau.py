"""Optical depth as a matmul.

The reference computes tau per (wavenumber, height) with a scalar Simpson
integration along the ray (transit/src/eclipse.c:28-105 eclipsetau;
transit/src/slantpath.c:18-108 totaltau1).  Both integrals are *linear* in
the per-layer extinction, including the parabolic tangent-point
interpolation (numerical.c:182-195 interp_parab), so each geometry
reduces to a precomputed path-weight matrix W with

    tau[wn, height] = er[wn, :] @ W[height, :].T

which is one matrix product for all wavenumbers and heights at once.
"""

from __future__ import annotations

import numpy as np
import torch

from transit_tpu_torch.numerics.simpson import simpson_weights_np


def _parab_coeffs(x3: np.ndarray, xr: float) -> np.ndarray:
    """Linear coefficients c with p(xr) = c @ y3 for interp_parab
    (numerical.c:182-195; equispaced-x assumption — uses dx = x1-x0 only).
    Computed by evaluating the reference formula on basis vectors so the
    floating-point behaviour matches the C code."""
    out = np.zeros(3)
    dx = x3[1] - x3[0]
    x0 = x3[0] / dx
    for k in range(3):
        y = np.zeros(3)
        y[k] = 1.0
        my = y[0] + y[2] - 2.0 * y[1]
        a = my / (2.0 * dx * dx)
        b = (y[2] - y[1] - (x0 + 1.5) * my) / dx
        c = y[0] + x0 * (y[2] - 4.0 * y[1] + 3.0 * y[0] + x0 * my) / 2.0
        out[k] = xr * xr * a + xr * b + c
    return out


def eclipse_weights(rad: np.ndarray) -> np.ndarray:
    """W (nh, nrad): vertical optical depth from height ri (0 = top) down
    to the top layer, eclipsetau (eclipse.c:28-105).

    The caller computes tau = rfct * er @ W.T.
    """
    rad = np.asarray(rad, dtype=np.float64)
    n = rad.shape[0]
    W = np.zeros((n, n))
    for ri in range(n):
        rs = n - 1 - ri
        if rs == n - 1:
            continue  # top layer: tau = 0 (eclipse.c:45-46)
        nseg = n - rs
        if nseg == 2:
            # eclipse.c:65-80: parabola over (rs-1, rs, rs+1) at rad[rs],
            # then a 3-point segment with an averaged midpoint:
            p = _parab_coeffs(rad[rs - 1:rs + 2], rad[rs])
            r3 = np.array([rad[rs], (rad[rs] + rad[rs + 1]) / 2.0,
                           rad[rs + 1]])
            s = np.concatenate([[0.0], np.cumsum(np.diff(r3))])
            w = simpson_weights_np(s)
            C = np.zeros((3, n))
            C[0, rs - 1:rs + 2] = p
            C[1, rs - 1:rs + 2] = p / 2.0
            C[1, rs + 1] += 0.5
            C[2, rs + 1] = 1.0
            W[ri] = w @ C
        else:
            # Parabola over (rs, rs+1, rs+2) evaluated at rad[rs] replaces
            # the first sample (eclipse.c:65-66); path coordinate is the
            # running sum of radius differences (eclipse.c:83-86):
            p = _parab_coeffs(rad[rs:rs + 3], rad[rs])
            s = np.concatenate([[0.0],
                                np.cumsum(np.diff(rad[rs:]))])
            w = simpson_weights_np(s)
            W[ri, rs:] = w
            W[ri, rs:rs + 3] += w[0] * p - w[0] * np.array([1.0, 0, 0])
    return W


def transit_weights(rad: np.ndarray, b: np.ndarray) -> np.ndarray:
    """W (nb, nrad): slant-path optical depth at impact parameters b
    (same units as rad), totaltau1 (slantpath.c:18-108).

    tau = rfct * er @ W.T (the x2 chord symmetry factor is included).
    """
    rad = np.asarray(rad, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    n = rad.shape[0]
    W = np.zeros((b.shape[0], n))
    for k, bk in enumerate(b):
        r0 = bk  # refraction index = 1
        # binsearch(rad, 0, n-1, r0) semantics (numerical.c:16-45):
        if r0 >= rad[n - 1]:
            continue          # outermost layer or above: tau = 0
        if r0 < rad[0]:
            raise ValueError(f"impact parameter {bk} below bottom layer")
        rs = int(np.searchsorted(rad, r0, side="right") - 1)
        nseg = n - rs
        if nseg == 2:
            # slantpath.c:57,62-74: parabola over (rs-1, rs, rs+1) at r0,
            # then 3 points with averaged midpoint:
            p = _parab_coeffs(rad[rs - 1:rs + 2], r0)
            r3 = np.array([r0, (r0 + rad[rs + 1]) / 2.0, rad[rs + 1]])
            s = np.zeros(3)
            s[1:] = np.sqrt(r3[1:] ** 2 - r0 * r0)
            w = simpson_weights_np(s)
            C = np.zeros((3, n))
            C[0, rs - 1:rs + 2] = p
            C[1, rs - 1:rs + 2] = p / 2.0
            C[1, rs + 1] += 0.5
            C[2, rs + 1] = 1.0
            W[k] = 2.0 * (w @ C)
        else:
            p = _parab_coeffs(rad[rs:rs + 3], r0)
            s = np.zeros(nseg)
            s[1:] = np.sqrt(rad[rs + 1:] ** 2 - r0 * r0)
            w = simpson_weights_np(s)
            W[k, rs:] = w
            W[k, rs:rs + 3] += w[0] * p - w[0] * np.array([1.0, 0, 0])
            W[k] *= 2.0
    return W


def optical_depth(er: torch.Tensor, W: torch.Tensor, rfct: float):
    """tau (nwn, nh) = rfct * er @ W.T  (tau.c:274).  A plain matrix
    product: on the card it runs in full float32 (the model turns TF32
    off)."""
    return rfct * er @ W.T


def last_index(tau: torch.Tensor, toomuch: float):
    """tau.last per wavenumber: first height index with tau > toomuch, or
    nh-1 if never reached (tau.c:277-304)."""
    over = (tau > toomuch).to(torch.uint8)
    nh = tau.shape[1]
    first = over.argmax(dim=1)
    any_over = over.amax(dim=1) > 0
    return torch.where(any_over, first, torch.full_like(first, nh - 1))
