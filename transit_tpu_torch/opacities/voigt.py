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

Exact mode's profile table (the second half of the module) ports the
reference-exact Pierluisi function :func:`voigt_k` (voigt.py:49-113) and
the bin-averaged profiles of voigtn (:func:`bin_averaged_profile`,
:func:`build_profile_table`, voigt.py:381-553).  It is set-up, once per
model: the fine samples are evaluated in float64 on the model's device,
the bin sums in numpy on the host, so that the table equals JAX's.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from transit_tpu_torch.constants import SQRTLN2, SQRTLN2PI, TWOOSQRTPI


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
    shapes.  The forward returns (K, wr, wi), the pair as outputs that
    carry no gradient, so that the backward can read them; torch.func
    transforms it (setup_context, a generated vmap rule: forward and
    backward are torch ops)."""

    generate_vmap_rule = True

    @staticmethod
    def forward(raw_w, x, y):
        wr, wi = raw_w(x, y)
        return SQRTLN2PI * wr, wr, wi

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, x, y = inputs
        _, wr, wi = output
        ctx.mark_non_differentiable(wr, wi)
        ctx.save_for_backward(x, y, wr, wi)

    @staticmethod
    def backward(ctx, ct, _wr, _wi):
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
    return _VoigtK.apply(_humlicek_w, x, y)[0]


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
    return _VoigtK.apply(_humlicek_w_r2, x, y)[0]


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
    return _VoigtK.apply(_w_asym2, x, y)[0]


# Voigt function of a plan by its ``wfn_tag`` (fast.py:125), and the
# kernels' selector for it (csrc/*.cu: template argument WFN).
FAR_KERNELS = {"w4": voigt_k_humlicek, "r2": voigt_k_humlicek_r2,
               "asym2": voigt_k_asym2}
# Their (Re w, Im w) pairs, which the plain VJPs evaluate (fast.py:_RAW_W).
RAW_W = {"w4": _humlicek_w, "r2": _humlicek_w_r2, "asym2": _w_asym2}
WFN_CODE = {"w4": 0, "r2": 1, "asym2": 2}


# ----------------------------------------------------------------------------
# The reference-exact Pierluisi function and the bin-averaged profile table
# of exact mode (transit_tpu.opacities.voigt, voigt.py:34-113, 381-553)
# ----------------------------------------------------------------------------

# Region II/III rational-approximation coefficients (pu/src/voigt.c:32-42):
_A1, _A2, _A3 = 0.46131350, 0.19016350, 0.09999216
_A4, _A5, _A6 = 1.78449270, 0.002883894, 5.52534370
_B1, _B2, _B3, _B4 = 0.51242424, 0.27525510, 0.05176536, 2.72474500

# ferf[n] = 1/(n! (2n+1)) (voigt.c:46-108).  29 terms cover NFCN for x < 3.
_MAX_ITERS = 29
_FERF = [1.0 / (math.factorial(n) * (2 * n + 1))
         for n in range(_MAX_ITERS + 1)]

# The reference's getprofile switches to VOIGT_QUICK above this many
# samples (pu/src/voigt.c:109, extinction.c:50-51):
VOIGT_MAXELEMENTS = 99999
# Fine samples evaluated at once by build_profile_table, by device
# (float64, ~30 temporaries of that size live at once: small on the CPU,
# where they stay in cache; large on the card, to keep launches few).
FINE_CHUNK = {"cpu": 1 << 16, "cuda": 1 << 22}


def _region1(x, y):
    """Region I of :func:`voigt_k`: the power series, n = NFCN(x, y) + 1
    terms (NFCN = 15 if x < 1 else int(6.842 x + 8)) of a fixed 29
    masked iterations, the inputs clamped at x <= 3 and y <= 1.8."""
    n_iters = torch.where(x < 1.0, 15, (6.842 * x + 8.0).to(torch.int32)) + 1
    xs = torch.clamp_max(x, 3.0)
    ys = torch.clamp_max(y, 1.8)
    sx2y2 = xs * xs - ys * ys
    sxy2 = 2.0 * xs * ys
    ar, ai = ys, -xs
    orr, oi = ar, ai
    for i in range(1, _MAX_ITERS + 1):
        ni = orr * sxy2 + oi * sx2y2
        nr = orr * sx2y2 - oi * sxy2
        take = (i <= n_iters).to(x.dtype)
        ar = ar + take * nr * _FERF[i]
        ai = ai + take * ni * _FERF[i]
        orr, oi = nr, ni
    return SQRTLN2PI * torch.exp(-sx2y2) * (
        torch.cos(sxy2) * (1.0 - ar * TWOOSQRTPI) -
        torch.sin(sxy2) * ai * TWOOSQRTPI)


def _rational(x, y, terms):
    """Regions II and III of :func:`voigt_k`: sqrt(ln2/pi) times the sum
    over (a, b) of ``terms`` of a (2x^2 y - (x^2 - y^2 - b) y) /
    ((x^2 - y^2 - b)^2 + (2xy)^2), in voigtxy's order of operations."""
    x2y2 = x * x - y * y
    xy2 = 2.0 * x * y
    ar2 = xy2 * xy2
    nr2 = xy2 * x
    acc = None
    for a, b in terms:
        n = x2y2 - b
        t = a * ((nr2 - n * y) / (n * n + ar2))
        acc = t if acc is None else acc + t
    return SQRTLN2PI * acc


_TERMS2 = ((_A1, _A2), (_A3, _A4), (_A5, _A6))
_TERMS3 = ((_B1, _B2), (_B3, _B4))


def voigt_k(x: torch.Tensor, y) -> torch.Tensor:
    """K(x, y) = sqrt(ln2/pi) Re[w(x + iy)] by the reference's
    three-region approximation (voigtxy, pu/src/voigt.c:132-200;
    voigt.py:49): region I (x < 3, y < 1.8) a power series of a fixed 29
    masked iterations with its inputs clamped at x <= 3 and y <= 1.8,
    region II (x < 5, y < 5) a 3-term and region III a 2-term rational.
    Elementwise, ``y`` broadcasts; each region is evaluated on its own
    elements only (the same operations on each element as JAX's
    select over all three)."""
    y = torch.as_tensor(y, dtype=x.dtype, device=x.device)
    x, y = torch.broadcast_tensors(x, y)
    in1 = (x < 3.0) & (y < 1.8)
    in2 = ~in1 & (x < 5.0) & (y < 5.0)
    out = torch.empty_like(x)
    for mask, fn in ((in1, _region1),
                     (in2, lambda a, b: _rational(a, b, _TERMS2)),
                     (~(in1 | in2), lambda a, b: _rational(a, b, _TERMS3))):
        out[mask] = fn(x[mask], y[mask])
    return out


def voigt_profile(wn, wn0, alphaL, alphaD):
    """Pointwise area-normalised Voigt profile, the reference's voigtf
    (voigt.c:205-227; voigt.py:381)."""
    y = SQRTLN2 * alphaL / alphaD
    x = SQRTLN2 * torch.abs(wn - wn0) / alphaD
    return voigt_k(x, y) / alphaD


def _voigtn_plan(nwn: int, dwn_half: float, alphaD: float, quick: bool):
    """Fine-grid sizing of voigtn (voigt.c:399-433; voigt.py:392):
    (nint, dint, center), the profile center as a fine-grid index:
    dint*i - dwn_half == (i - center)*dint.  The coarse branch takes
    dint = 2*dwn_half/(nwn-1), center (nwn-1)/2; the sub-sampled one
    dint = 2*dwn_half/(nint-1), center (nint-1)/2."""
    ddwn = 2.0 * dwn_half / (nwn - 1)
    nint = 50
    dint = alphaD / (nint - 1)
    if ddwn < dint or quick:
        dint = ddwn
        nint = nwn + 1
        center = (nwn - 1) / 2.0
    else:
        nint = int(ddwn / dint) + 1
        if nint & 1:
            nint += 1
        nint = nwn * nint + 1
        dint = 2.0 * dwn_half / (nint - 1)
        center = (nint - 1) / 2.0
    return nint, dint, center


def _fine_eval(i, center, dint, alphaL, alphaD):
    """The fine-sampled Voigt at the fine-grid indices ``i`` (voigt.py:418):
    the distance from the center as (i - center)*dint, free of the
    reference's dint*i - dwn_half cancellation.  Elementwise: every
    argument may be a tensor of i's shape (one profile's parameters per
    element), in i's dtype."""
    d = i - center
    x = SQRTLN2 * torch.abs(d) * dint / alphaD
    y = SQRTLN2 * alphaL / alphaD
    return voigt_k(x, y) / alphaD


def _bin_average(fine: np.ndarray, nwn: int, quick: bool) -> np.ndarray:
    """Bin averages of one profile's float32 fine samples, numpy float32
    sums exactly as transit_tpu's bin_averaged_profile takes them
    (voigt.py:456-473): Simpson (meanintegSimp) for an odd count of
    samples per bin, else the trapezoid (meanintegTrap); the lower-edge
    sample itself when ``quick`` (VOIGT_QUICK)."""
    if quick:
        return fine[:nwn]
    nint = fine.shape[0]
    ipo = int(float(nint - 1) / nwn) + 1   # fine samples per bin, +1 shared
    step = ipo - 1
    if step * nwn != nint - 1:
        raise ValueError(f"voigtn: {nint} fine samples do not split into "
                         f"{nwn} bins")
    body = fine[:-1].reshape(nwn, step).astype(np.float32)
    ends = fine[step::step]
    if ipo & 1:
        s_odd = body[:, 1::2].sum(axis=1, dtype=np.float32)
        s_even = body[:, 2::2].sum(axis=1, dtype=np.float32)
        out = ((s_odd * np.float32(2.0) + s_even) * np.float32(2.0)
               + body[:, 0] + ends) / np.float32(step * 3.0)
    else:
        mid = body[:, 1:].sum(axis=1, dtype=np.float32)
        out = (mid + (body[:, 0] + ends) / np.float32(2.0)) / np.float32(step)
    return out.astype(np.float32)


def bin_averaged_profiles(specs, device="cpu") -> list:
    """Bin-averaged Voigt profiles, float32, exactly following voigtn
    (voigt.c:369-483) with eps=-1 (fixed iteration counts), for ``specs``
    [(nwn, dwn_half, alphaL, alphaD, quick)].  The fine samples of all
    profiles are evaluated together in float64 on ``device``, FINE_CHUNK
    at a time (each element with its profile's parameters), cast to
    float32 there; the per-bin sums are numpy's on the host
    (:func:`_bin_average`), so the profiles equal transit_tpu's under x64
    to the bit, but for a float64 libm ulp that survives the cast."""
    plans = [_voigtn_plan(nwn, dh, aD, q) for nwn, dh, _, aD, q in specs]
    if not plans:
        return []
    f64 = dict(dtype=torch.float64, device=device)
    nint = torch.tensor([p[0] for p in plans], device=device)
    start = torch.cumsum(nint, 0) - nint
    par = torch.tensor([[p[2], p[1], s[2], s[3]] for p, s in
                        zip(plans, specs)], **f64)  # center, dint, aL, aD
    total = int(nint.sum())
    chunk = FINE_CHUNK[torch.device(device).type]
    fine = np.empty(total, dtype=np.float32)
    for a in range(0, total, chunk):
        idx = torch.arange(a, min(total, a + chunk), device=device)
        prof = torch.searchsorted(start, idx, right=True) - 1
        p = par[prof]
        val = _fine_eval((idx - start[prof]).to(torch.float64), p[:, 0],
                         p[:, 1], p[:, 2], p[:, 3])
        fine[a:a + idx.shape[0]] = val.to(torch.float32).cpu().numpy()
    out, off = [], 0
    for (n, _, _), (nwn, _, _, _, q) in zip(plans, specs):
        out.append(_bin_average(fine[off:off + n], nwn, q))
        off += n
    return out


def bin_averaged_profile(nwn: int, dwn_half: float, alphaL: float,
                         alphaD: float, quick: bool = False,
                         device="cpu") -> np.ndarray:
    """One bin-averaged Voigt profile (voigt.py:442), float32: the bins
    take the lower-edge-anchored average over one bin width; when
    ``quick``, the lower-edge sample itself (VOIGT_QUICK).  See
    :func:`bin_averaged_profiles`."""
    return bin_averaged_profiles([(nwn, dwn_half, alphaL, alphaD, quick)],
                                 device)[0]


@dataclasses.dataclass
class ProfileTable:
    """Grid of bin-averaged Voigt profiles over (Doppler, Lorentz) widths
    (voigt.py:477): calcprofiles' log-spaced width axes (opacity.c:218-277),
    per-cell half-size ``profsize``, profile reuse when aDop*10 < aLor
    (i != 0), getprofile's size rule (extinction.c:8-57).  The profiles
    are concatenated in one flat float32 buffer addressed by ``base``."""
    aDop: np.ndarray        # (nDop,) Doppler width samples
    aLor: np.ndarray        # (nLor,) Lorentz width samples
    profsize: np.ndarray    # (nDop, nLor) int64 half sizes
    base: np.ndarray        # (nDop, nLor) int64 offsets into flat
    flat: np.ndarray        # (total,) float32 concatenated profiles

    @property
    def ndop(self):
        return self.aDop.shape[0]

    @property
    def nlor(self):
        return self.aLor.shape[0]


def logspace_ref(vmin: float, vmax: float, n: int) -> np.ndarray:
    """Reference logspace (pu/src/iomisc.c:1064-1083; voigt.py:501)."""
    logmin = math.log10(vmin)
    logmax = math.log10(vmax)
    logstep = (logmax - logmin) / (n - 1.0)
    return np.array([10.0 ** (logmin + i * logstep) for i in range(n)])


def getprofile_size(dwn: float, dop: float, lor: float, nwidth: float,
                    nwave: int) -> int:
    """Number of profile samples, reference getprofile (extinction.c:8-57;
    voigt.py:509)."""
    bigalpha = max(dop, lor)
    wvgt = bigalpha * nwidth
    nvgt = 2 * int(wvgt / dwn + 0.5) + 1
    if nvgt < 2:
        nvgt = 3
    if nvgt > 2 * nwave:
        nvgt = 2 * nwave + 1
    return nvgt


def _table_layout(dwn: float, nwave: int, nwidth: float, ndop: int,
                  nlor: int, dmin: float, dmax: float, lmin: float,
                  lmax: float):
    """(aDop, aLor, profsize, base, specs) of the table: the width axes,
    each cell's half size and offset into the flat buffer (a reused
    profile shares its cell's), and the distinct profiles'
    bin_averaged_profiles specs in buffer order."""
    aDop = logspace_ref(dmin, dmax, ndop)
    aLor = logspace_ref(lmin, lmax, nlor)
    profsize = np.zeros((ndop, nlor), dtype=np.int64)
    base = np.zeros((ndop, nlor), dtype=np.int64)
    specs = []
    offset = 0
    for i in range(ndop):
        for j in range(nlor):
            if aDop[i] * 10.0 < aLor[j] and i != 0:
                profsize[i, j] = profsize[i - 1, j]
                base[i, j] = base[i - 1, j]
                continue
            nvgt = getprofile_size(dwn, aDop[i], aLor[j], nwidth, nwave)
            specs.append((nvgt, dwn * (nvgt // 2), aLor[j], aDop[i],
                          nvgt > VOIGT_MAXELEMENTS))
            profsize[i, j] = nvgt // 2
            base[i, j] = offset
            offset += nvgt
    return aDop, aLor, profsize, base, specs


def build_profile_table(dwn: float, nwave: int, nwidth: float,
                        ndop: int = 60, nlor: int = 60,
                        dmin: float = 1e-3, dmax: float = 0.25,
                        lmin: float = 1e-4, lmax: float = 10.0,
                        device="cpu") -> ProfileTable:
    """The (nDop x nLor) bin-averaged profile table (calcprofiles;
    voigt.py:522) on the fine (oversampled) spacing ``dwn`` over
    ``nwave`` fine wavenumbers, wings of ``nwidth`` half-widths.  The
    cells' sizes and reuse are decided on the host; the distinct
    profiles are evaluated together on ``device``
    (:func:`bin_averaged_profiles`)."""
    aDop, aLor, profsize, base, specs = _table_layout(
        dwn, nwave, nwidth, ndop, nlor, dmin, dmax, lmin, lmax)
    chunks = bin_averaged_profiles(specs, device)
    flat = (np.concatenate(chunks) if chunks
            else np.zeros(0, dtype=np.float32))
    return ProfileTable(aDop=aDop, aLor=aLor, profsize=profsize, base=base,
                        flat=flat)


def check_profile_table(table: ProfileTable, dwn: float, nwave: int,
                        nwidth: float, ndop: int = 60, nlor: int = 60,
                        dmin: float = 1e-3, dmax: float = 0.25,
                        lmin: float = 1e-4, lmax: float = 10.0) -> None:
    """Raise ValueError unless ``table`` has the layout that
    build_profile_table gives these arguments: the same width axes, cell
    sizes, offsets and buffer length (the profile values are not
    recomputed)."""
    aDop, aLor, profsize, base, specs = _table_layout(
        dwn, nwave, nwidth, ndop, nlor, dmin, dmax, lmin, lmax)
    for name, want in (("aDop", aDop), ("aLor", aLor),
                       ("profsize", profsize), ("base", base)):
        if not np.array_equal(getattr(table, name), want):
            raise ValueError(f"profile table: {name} is not this "
                             f"configuration's")
    if table.flat.shape != (sum(sp[0] for sp in specs),):
        raise ValueError(f"profile table: {table.flat.shape[0]} values, "
                         f"this configuration's has "
                         f"{sum(sp[0] for sp in specs)}")
