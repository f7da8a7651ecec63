"""Voigt functions of the two line-by-line schemes, plain torch.

Fast mode's K(x, y) = sqrt(ln2/pi) Re w(x + iy) is the Humlicek (1982)
w4 approximation, in real-pair complex arithmetic with region II in the
v = 1/u form (Humlicek's regions: II where |x| + y >= 5.5, IV where
y < 0.195|x| - 0.176 below that, III elsewhere); its gradient is the
Faddeeva identity w'(z) = -2 z w + 2i/sqrt(pi) on the computed pair.
Exact mode's profiles are the reference C code's: the three-region
Pierluisi function (pu/src/voigt.c voigtxy) sampled on a fine grid and
averaged over each fine bin (voigtn), tabulated over log-spaced Doppler
and Lorentz widths (calcprofiles, getprofile).  This table keeps the
bin averages in float64; the C code and the program keep float32."""

from __future__ import annotations

import math

import numpy as np
import torch

from .constants import SQRTLN2, SQRTLN2PI, TWOOSQRTPI


def humlicek_region(x, y):
    """2, 3 or 4 per element: the w4 region of (x, y) (I is part of II)."""
    r2 = (x.abs() + y) >= 5.5
    r4 = ~r2 & (y < 0.195 * x.abs() - 0.176)
    return torch.where(r2, 2, torch.where(r4, 4, 3))


def humlicek_w(x, y):
    """(Re w, Im w) of w4 at x + iy, elementwise (x, y of one shape)."""
    def cmul(ar, ai, br, bi):
        return ar * br - ai * bi, ar * bi + ai * br

    def horner(tr_, ti_, coeffs):
        pr, pi = torch.full_like(tr_, coeffs[-1]), torch.zeros_like(tr_)
        for c in reversed(coeffs[:-1]):
            pr, pi = cmul(pr, pi, tr_, ti_)
            pr = pr + c
        return pr, pi

    where = torch.where
    region = humlicek_region(x, y)
    in2, in4 = region == 2, region == 4
    in3 = region == 3
    tr, ti = y, -x
    ur, ui = (y - x) * (y + x), -2.0 * x * y
    # Region II: t (1.410474 v^2 + 0.5641896 v) / (1 + 3 v + 0.75 v^2),
    # v = 1/u:
    u2r, u2i = where(in2, ur, 16.0), where(in2, ui, 0.0)
    uinv = 1.0 / (u2r * u2r + u2i * u2i)
    vr, vi = u2r * uinv, -u2i * uinv
    v2r, v2i = cmul(vr, vi, vr, vi)
    n2r, n2i = cmul(where(in2, tr, 1.0), where(in2, ti, 0.0),
                    1.410474 * v2r + 0.5641896 * vr,
                    1.410474 * v2i + 0.5641896 * vi)
    d2r, d2i = 1.0 + 3.0 * vr + 0.75 * v2r, 3.0 * vi + 0.75 * v2i
    # Region III: a degree-4 over a degree-5 polynomial in t:
    t3r, t3i = where(in3, tr, 1.0), where(in3, ti, 0.0)
    n3r, n3i = horner(t3r, t3i,
                      [16.4955, 20.20933, 11.96482, 3.778987, 0.5642236])
    d3r, d3i = horner(t3r, t3i,
                      [16.4955, 38.82363, 39.27121, 21.69274, 6.699398, 1.0])
    # Region IV: exp(u) - t P(u) / Q(u):
    u4r, u4i = where(in4, ur, -1.0), where(in4, ui, 0.0)
    t4r, t4i = where(in4, tr, 1.0), where(in4, ti, 0.0)
    p4r, p4i = horner(u4r, u4i, [36183.31, -3321.9905, 1540.787, -219.0313,
                                 35.76683, -1.320522, 0.56419])
    q4r, q4i = horner(u4r, u4i, [32066.6, -24322.84, 9022.228, -2186.181,
                                 364.2191, -61.57037, 1.841439, -1.0])
    n4r, n4i = cmul(t4r, t4i, p4r, p4i)
    eu = torch.exp(u4r)
    nr = where(in2, n2r, where(in4, n4r, n3r))
    ni = where(in2, n2i, where(in4, n4i, n3i))
    dr = where(in2, d2r, where(in4, q4r, d3r))
    di = where(in2, d2i, where(in4, q4i, d3i))
    dinv = 1.0 / (dr * dr + di * di)
    re = (nr * dr + ni * di) * dinv
    im = (ni * dr - nr * di) * dinv
    return (where(in4, eu * torch.cos(u4i) - re, re),
            where(in4, eu * torch.sin(u4i) - im, im))


class VoigtK(torch.autograd.Function):
    """K(x, y) of w4 with the Faddeeva-identity gradient (x, y of one
    shape)."""

    @staticmethod
    def forward(ctx, x, y):
        wr, wi = humlicek_w(x, y)
        ctx.save_for_backward(x, y, wr, wi)
        return SQRTLN2PI * wr

    @staticmethod
    def backward(ctx, ct):
        x, y, wr, wi = ctx.saved_tensors
        ct = ct * SQRTLN2PI
        return (ct * -2.0 * (x * wr - y * wi),
                ct * (2.0 * (x * wi + y * wr) - TWOOSQRTPI))


# --- exact mode's profile table ---------------------------------------------

_A = ((0.46131350, 0.19016350), (0.09999216, 1.78449270),
      (0.002883894, 5.52534370))
_B = ((0.51242424, 0.27525510), (0.05176536, 2.72474500))
_FERF = [1.0 / (math.factorial(n) * (2 * n + 1)) for n in range(30)]


def _region1(x, y):
    n_iter = torch.where(x < 1.0, 15, (6.842 * x + 8.0).to(torch.int32)) + 1
    xs, ys = x.clamp_max(3.0), y.clamp_max(1.8)
    a2, b2 = xs * xs - ys * ys, 2.0 * xs * ys
    ar, ai = ys, -xs
    pr, pi = ar, ai
    for i in range(1, 30):
        pr, pi = pr * a2 - pi * b2, pr * b2 + pi * a2
        take = (i <= n_iter).to(x.dtype)
        ar = ar + take * pr * _FERF[i]
        ai = ai + take * pi * _FERF[i]
    return SQRTLN2PI * torch.exp(-a2) * (
        torch.cos(b2) * (1.0 - ar * TWOOSQRTPI) -
        torch.sin(b2) * ai * TWOOSQRTPI)


def _rational(x, y, terms):
    x2y2, xy2 = x * x - y * y, 2.0 * x * y
    acc = 0.0
    for a, b in terms:
        n = x2y2 - b
        acc = acc + a * ((xy2 * x - n * y) / (n * n + xy2 * xy2))
    return SQRTLN2PI * acc


def voigt_k(x, y):
    """The reference's three-region K(x, y) (voigtxy): region I (x < 3,
    y < 1.8) a power series, II (x < 5, y < 5) a 3-term, III a 2-term
    rational; each region evaluated on its own elements."""
    in1 = (x < 3.0) & (y < 1.8)
    in2 = ~in1 & (x < 5.0) & (y < 5.0)
    out = torch.empty_like(x)
    for m, fn in ((in1, _region1), (in2, lambda a, b: _rational(a, b, _A)),
                  (~(in1 | in2), lambda a, b: _rational(a, b, _B))):
        out[m] = fn(x[m], y[m])
    return out


def _logspace(vmin, vmax, n):
    lo, hi = math.log10(vmin), math.log10(vmax)
    step = (hi - lo) / (n - 1.0)
    return np.array([10.0 ** (lo + i * step) for i in range(n)])


def _profile_size(dwn, dop, lor, nwidth, nwave):
    nvgt = 2 * int(max(dop, lor) * nwidth / dwn + 0.5) + 1
    if nvgt < 2:
        nvgt = 3
    if nvgt > 2 * nwave:
        nvgt = 2 * nwave + 1
    return nvgt


def _fine_plan(nwn, dwn_half, alpha_d, quick):
    """(fine samples, their spacing, the center's fine index) of voigtn's
    fine grid for one profile of nwn bins of half width dwn_half."""
    ddwn = 2.0 * dwn_half / (nwn - 1)
    dint = alpha_d / 49
    if ddwn < dint or quick:
        return nwn + 1, ddwn, (nwn - 1) / 2.0
    nint = int(ddwn / dint) + 1
    nint += nint & 1
    nint = nwn * nint + 1
    return nint, 2.0 * dwn_half / (nint - 1), (nint - 1) / 2.0


def _bin_average(fine, nwn, quick):
    """Bin averages of one profile's fine samples (float64): Simpson for
    an odd count of samples a bin, else the trapezoid; the lower-edge
    sample when ``quick``."""
    if quick:
        return fine[:nwn]
    step = (fine.shape[0] - 1) // nwn
    body = fine[:-1].reshape(nwn, step)
    ends = fine[step::step]
    if (step + 1) & 1:
        return ((body[:, 1::2].sum(1) * 2.0 + body[:, 2::2].sum(1)) * 2.0 +
                body[:, 0] + ends) / (step * 3.0)
    return (body[:, 1:].sum(1) + (body[:, 0] + ends) / 2.0) / step


class ProfileTable:
    """Bin-averaged profiles over (Doppler, Lorentz) widths: ``aDop``
    (ndop,), ``aLor`` (nlor,), each cell's half size ``size`` and
    ``base`` in the float64 buffer ``flat`` (a cell with aDop*10 < aLor
    and a Doppler index above 0 reuses the cell below it), as
    calcprofiles (opacity.c:218-277) builds it."""

    def __init__(self, dwn, nwave, nwidth, ndop, nlor, dmin, dmax, lmin,
                 lmax, device):
        self.aDop = _logspace(dmin, dmax, ndop)
        self.aLor = _logspace(lmin, lmax, nlor)
        size = np.zeros((ndop, nlor), dtype=np.int64)
        base = np.zeros((ndop, nlor), dtype=np.int64)
        specs, off = [], 0
        for i in range(ndop):
            for j in range(nlor):
                if self.aDop[i] * 10.0 < self.aLor[j] and i != 0:
                    size[i, j], base[i, j] = size[i - 1, j], base[i - 1, j]
                    continue
                n = _profile_size(dwn, self.aDop[i], self.aLor[j], nwidth,
                                  nwave)
                specs.append((n, dwn * (n // 2), self.aLor[j], self.aDop[i],
                              n > 99999))
                size[i, j], base[i, j] = n // 2, off
                off += n
        self.size, self.base = size, base
        self.flat = _profiles(specs, device)


def _profiles(specs, device, chunk=1 << 22):
    """The bin-averaged profiles of ``specs`` [(bins, half width, alphaL,
    alphaD, quick)] concatenated: every fine sample evaluated together on
    ``device`` in float64, ``chunk`` at a time, each with its profile's
    parameters; the bin averages in numpy."""
    plans = [_fine_plan(n, h, ad, q) for n, h, _, ad, q in specs]
    f64 = dict(dtype=torch.float64, device=device)
    nint = torch.tensor([p[0] for p in plans], device=device)
    start = torch.cumsum(nint, 0) - nint
    par = torch.tensor([[p[2], p[1], s[2], s[3]] for p, s in
                        zip(plans, specs)], **f64)  # center, dint, aL, aD
    total = int(nint.sum())
    fine = np.empty(total)
    for a in range(0, total, chunk):
        idx = torch.arange(a, min(total, a + chunk), device=device)
        k = torch.searchsorted(start, idx, right=True) - 1
        c, dint, al, ad = par[k].unbind(1)
        x = SQRTLN2 * ((idx - start[k]).to(torch.float64) - c).abs() * \
            dint / ad
        fine[a:a + idx.shape[0]] = (voigt_k(x, SQRTLN2 * al / ad) /
                                    ad).cpu().numpy()
    out, off = [], 0
    for (n, _, _), (nwn, _, _, _, q) in zip(plans, specs):
        out.append(_bin_average(fine[off:off + n], nwn, q))
        off += n
    return np.concatenate(out)
