"""Humlicek w4 Voigt profile and the far-wing kernels on tensors.

The plain PyTorch counterpart of transit_tpu.opacities.voigt's
``_humlicek_w`` / ``voigt_k_humlicek`` (voigt.py:116-249), its region II
alone (``_humlicek_w_r2``, :272-323) and the two-term asymptotic pair
(``_w_asym2``, :334-370).  They are the Voigt functions of the kernels'
plain versions (opacities/kernel_lbl.py, opacities/kernel_shell.py), and
the CUDA kernels (csrc/*.cu) evaluate the same formulas with the same
constants.  The numerical
contracts carry over unchanged:

  * real-pair complex arithmetic;
  * region I (s >= 15) folded into region II, whose rational is valid on
    all of s >= 5.5;
  * region II in the v = 1/u form — the direct u^2 form overflows float32
    once |x| >~ 6e4;
  * the three rationals share one divide, numerator and denominator
    selected per element, and masked-out elements are fed safe values so
    they stay finite.

The three K functions are ``torch.autograd.Function``s with JAX's custom
VJP (voigt.py:209-269): the gradient comes from the Faddeeva identity
w'(z) = -2 z w(z) + 2i/sqrt(pi) on the computed (Re w, Im w), not from
autograd through the rationals, so it is the derivative of the true Voigt
function to the approximation's accuracy, as in JAX.
"""

from __future__ import annotations

import torch

from transit_tpu_torch.constants import SQRTLN2PI, TWOOSQRTPI


def humlicek_regions(x: torch.Tensor, y: torch.Tensor):
    """Boolean masks (II, III, IV) of the Humlicek region each (x, y)
    falls in; region I is part of II."""
    in2 = (x.abs() + y) >= 5.5
    in4 = (~in2) & (y < 0.195 * x.abs() - 0.176)
    in3 = ~(in2 | in4)
    return in2, in3, in4


def _humlicek_w(x: torch.Tensor, y: torch.Tensor):
    """Humlicek (1982) w4 as a real pair: (Re w(x+iy), Im w(x+iy))."""
    x, y = torch.broadcast_tensors(x, y)
    where = torch.where

    def cmul(ar, ai, br, bi):
        return ar * br - ai * bi, ar * bi + ai * br

    def horner(tr_, ti_, coeffs):
        # complex Horner: p(t) with real coefficients, highest degree last
        pr = torch.full_like(tr_, coeffs[-1])
        pi = torch.zeros_like(tr_)
        for c in reversed(coeffs[:-1]):
            pr, pi = cmul(pr, pi, tr_, ti_)
            pr = pr + c
        return pr, pi

    tr, ti = y, -x                       # t = y - i x
    ur = (y - x) * (y + x)               # u = t^2
    ui = -2.0 * x * y
    in2, in3, in4 = humlicek_regions(x, y)

    # Region II (s >= 5.5): w = t (1.410474 v^2 + 0.5641896 v) /
    # (1 + 3 v + 0.75 v^2) with v = 1/u (|v| <= 1/15 in region):
    u2r, u2i = where(in2, ur, 16.0), where(in2, ui, 0.0)
    t2r, t2i = where(in2, tr, 1.0), where(in2, ti, 0.0)
    uinv = 1.0 / (u2r * u2r + u2i * u2i)
    vr, vi = u2r * uinv, -u2i * uinv
    v2r, v2i = cmul(vr, vi, vr, vi)
    n2r, n2i = cmul(t2r, t2i,
                    1.410474 * v2r + 0.5641896 * vr,
                    1.410474 * v2i + 0.5641896 * vi)
    d2r = 1.0 + 3.0 * vr + 0.75 * v2r
    d2i = 3.0 * vi + 0.75 * v2i

    # Region III: degree-4 / degree-5 rational in t:
    t3r, t3i = where(in3, tr, 1.0), where(in3, ti, 0.0)
    n3r, n3i = horner(t3r, t3i,
                      [16.4955, 20.20933, 11.96482, 3.778987, 0.5642236])
    d3r, d3i = horner(t3r, t3i,
                      [16.4955, 38.82363, 39.27121, 21.69274, 6.699398, 1.0])

    # Region IV: w = exp(u) - t * P(u)/Q(u)  (alternating-sign polys in u):
    u4r, u4i = where(in4, ur, -1.0), where(in4, ui, 0.0)
    t4r, t4i = where(in4, tr, 1.0), where(in4, ti, 0.0)
    pc = [36183.31, -3321.9905, 1540.787, -219.0313, 35.76683,
          -1.320522, 0.56419]
    qc = [32066.6, -24322.84, 9022.228, -2186.181, 364.2191,
          -61.57037, 1.841439, -1.0]
    p4r, p4i = horner(u4r, u4i, pc)
    q4r, q4i = horner(u4r, u4i, qc)
    n4r, n4i = cmul(t4r, t4i, p4r, p4i)
    # exp(u) = exp(ur) (cos ui + i sin ui); in-region ur < 0:
    eu = torch.exp(u4r)
    exp_re = eu * torch.cos(u4i)
    exp_im = eu * torch.sin(u4i)

    # One shared divide: n/d with n, d selected per element:
    nr = where(in2, n2r, where(in4, n4r, n3r))
    ni = where(in2, n2i, where(in4, n4i, n3i))
    dr = where(in2, d2r, where(in4, q4r, d3r))
    di = where(in2, d2i, where(in4, q4i, d3i))
    dinv = 1.0 / (dr * dr + di * di)
    re = (nr * dr + ni * di) * dinv
    im = (ni * dr - nr * di) * dinv
    wr = where(in4, exp_re - re, re)
    wi = where(in4, exp_im - im, im)
    return wr, wi


def _reduce_to(g: torch.Tensor, shape) -> torch.Tensor:
    """Sum a broadcast gradient back down to an input's shape
    (voigt.py:209)."""
    shape = tuple(shape)
    if tuple(g.shape) == shape:
        return g
    nd = g.dim() - len(shape)
    if nd:
        g = g.sum(dim=tuple(range(nd)))
    ax = tuple(i for i, n in enumerate(shape) if n == 1 and g.shape[i] != 1)
    if ax:
        g = g.sum(dim=ax, keepdim=True)
    return g


def faddeeva_partials(x, y, wr, wi):
    """(Kx', Ky') = (dK/dx, dK/dy) / sqrt(ln2/pi) from the Faddeeva
    identity (voigt.py:_vkh_bwd): -2 (x wr - y wi) and
    2 (x wi + y wr) - 2/sqrt(pi)."""
    return -2.0 * (x * wr - y * wi), 2.0 * (x * wi + y * wr) - TWOOSQRTPI


class _VoigtK(torch.autograd.Function):
    """K = sqrt(ln2/pi) Re w of the pair function ``raw_w``, with JAX's
    backward ``_vkh_bwd`` (voigt.py:257): dK/dx = -2C (x wr - y wi),
    dK/dy = 2C (x wi + y wr) - 2C/sqrt(pi), reduced to the inputs'
    shapes."""

    @staticmethod
    def forward(ctx, raw_w, x, y):
        wr, wi = raw_w(x, y)
        ctx.save_for_backward(x, y, wr, wi)
        return SQRTLN2PI * wr

    @staticmethod
    def backward(ctx, ct):
        x, y, wr, wi = ctx.saved_tensors
        kxp, kyp = faddeeva_partials(x.to(wr.dtype), y.to(wr.dtype), wr, wi)
        ct = ct * SQRTLN2PI
        return (None, _reduce_to(ct * kxp, x.shape),
                _reduce_to(ct * kyp, y.shape))


def voigt_k_humlicek(x: torch.Tensor, y: torch.Tensor):
    """K(x, y) = sqrt(ln2/pi) Re[w(x + iy)] via the Humlicek w4
    rational approximation (voigt.py:225), with the Faddeeva-identity
    gradient.  Multiply by 1/alphaD for the area-normalised profile
    value."""
    return _VoigtK.apply(_humlicek_w, x, y)


def _humlicek_w_r2(x: torch.Tensor, y: torch.Tensor):
    """Region II of the w4 pair alone, (Re w, Im w): the v = 1/u form,
    with |u|^2 floored at 1 so that zero-weighted padding lanes
    (x ~ y ~ 0) stay finite; valid lanes have |u|^2 >= 900."""
    x, y = torch.broadcast_tensors(x, y)
    tr, ti = y, -x
    ur = (y - x) * (y + x)
    ui = -2.0 * x * y
    uinv = 1.0 / torch.clamp_min(ur * ur + ui * ui, 1.0)
    vr, vi = ur * uinv, -ui * uinv
    v2r = vr * vr - vi * vi
    v2i = 2.0 * vr * vi
    cr = 1.410474 * v2r + 0.5641896 * vr
    ci = 1.410474 * v2i + 0.5641896 * vi
    nr = tr * cr - ti * ci
    ni = tr * ci + ti * cr
    dr = 1.0 + 3.0 * vr + 0.75 * v2r
    di = 3.0 * vi + 0.75 * v2i
    dinv = 1.0 / (dr * dr + di * di)
    return (nr * dr + ni * di) * dinv, (ni * dr - nr * di) * dinv


def voigt_k_humlicek_r2(x: torch.Tensor, y: torch.Tensor):
    """K(x, y) from region II of w4 alone (voigt.py:310): equal to
    :func:`voigt_k_humlicek` wherever |x| + y >= 5.5 — the far-wing
    stride-1 shells.  Faddeeva-identity gradient."""
    return _VoigtK.apply(_humlicek_w_r2, x, y)


def _w_asym2(x: torch.Tensor, y: torch.Tensor):
    """Two-term asymptotic Faddeeva pair w(z) ~ (i/sqrt(pi)) (1/z +
    1/(2 z^3)), z = x + iy, as (Re w, Im w); relative error <= 3/(4|z|^4).
    |z|^2 is floored at 1 (valid lanes have |z|^2 >= 121)."""
    x, y = torch.broadcast_tensors(x, y)
    r2 = torch.clamp_min(x * x + y * y, 1.0)
    rinv = 1.0 / r2
    ur = x * rinv                 # 1/z = (x - i y)/|z|^2
    ui = -y * rinv
    u2r = ur * ur - ui * ui
    u2i = 2.0 * ur * ui
    fr = ur * (1.0 + 0.5 * u2r) - 0.5 * ui * u2i
    fi = ui * (1.0 + 0.5 * u2r) + 0.5 * ur * u2i
    inv_sqrtpi = 0.5 * TWOOSQRTPI
    return -fi * inv_sqrtpi, fr * inv_sqrtpi


def voigt_k_asym2(x: torch.Tensor, y: torch.Tensor):
    """K(x, y) from the two-term asymptotic pair (voigt.py:365): the outer
    far-wing shells, where every line sits at x >= X_ASYM.
    Faddeeva-identity gradient."""
    return _VoigtK.apply(_w_asym2, x, y)


# Voigt function of a plan by its ``wfn_tag`` (fast.py:125), and the
# kernels' selector for it (csrc/*.cu: template argument WFN).
FAR_KERNELS = {"w4": voigt_k_humlicek, "r2": voigt_k_humlicek_r2,
               "asym2": voigt_k_asym2}
# Their (Re w, Im w) pairs, which the plain VJPs evaluate (fast.py:_RAW_W).
RAW_W = {"w4": _humlicek_w, "r2": _humlicek_w_r2, "asym2": _w_asym2}
WFN_CODE = {"w4": 0, "r2": 1, "asym2": 2}
