"""Line extinction on a tile plan through the CUDA line-tile kernel — the
counterpart of transit_tpu.opacities.pallas_lbl, and of the near tiles and
stride-1 far shells of the banded path (fast._run_tiles with a per-layer
wing cutoff).

``kernel_extinction`` takes the arguments of ``pallas_extinction``
(pallas_lbl.py:101) and returns the line extinction (nlayer, n_coarse):
for each tile, layer and bin, the sum over the tile's lines of
k * K(x, y) / alphaD, where

  * k = gf e^(-c2 El/T) (1 - e^(-c2 nu/T)) coef0 dens, dropped to 0 when
    the line's k0 < ethresh * kmax (extinction.c:400-427, 467-470);
  * K is the Humlicek w4 Voigt function, taken where
    |dnu| <= nwidth * max(alphaD, alphaL).

The per-(layer, isotope) tables (widths, strength coefficient, density)
are torch ops here, as JAX computes them outside ``pallas_call``.  On a
CUDA tensor the wrapper launches two kernels of csrc/line_tile.cu, or
raises: ``layer_kmax``, the species-collapsed per-layer kmax over the
full line list (the scan JAX runs outside ``pallas_call``), and
``line_tile_extinction``.  On a CPU tensor it computes
:func:`plain_extinction`, the plain PyTorch version of the same
function, with :func:`plain_kmax` for the scan.

The banded path (opacities/banded.py) launches the same kernel per tile
class of a plan, on the band's layer rows, with the Voigt function of the
plan's ``wfn_tag`` and the bin wavenumbers rounded as fast._run_tiles
rounds them (``bins_first``); :func:`plain_line_tiles` is its plain
version.

The gradient: :class:`LineExtinction`, an autograd Function of the layer
temperatures and the four tables, whose backward launches
``line_tile_backward`` (the counterpart of fast._block_val_bwd,
fast.py:608-680) on a CUDA tensor, or takes :func:`plain_line_tiles_vjp`.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from transit_tpu_torch.constants import SQRTLN2, SQRTLN2PI, SIGCTE, EXPCTE
from transit_tpu_torch.opacities.fast import FastPlan, _layer_widths
from transit_tpu_torch.opacities.voigt import (FAR_KERNELS, RAW_W,
                                               WFN_CODE, faddeeva_partials,
                                               humlicek_regions)
from transit_tpu_torch.utils import log
from transit_tpu_torch.utils.log import span

# Elements of the (layer, tile, bin, line) volume the plain version
# holds at once; it walks the tiles in chunks of this size: small enough
# on the CPU for its temporaries to stay in cache, large on the card to
# keep its launches few.
PLAIN_ELEMENTS = {"cpu": 1 << 18, "cuda": 1 << 25}
# Lines per chunk of the strength pre-pass (kmax scan).
KMAX_CHUNK = 1 << 16
# The plain VJPs' Voigt-pair dtype (voigt_bin_sums): None takes the
# forward's, as fast._block_val_bwd (fast.py:612) and the backward kernels
# do; a dtype forces it (float64 in a float32 model for the precision
# study, tests/test_torch_grad_precision_main.py).
PAIR_DTYPE = None
# Tile classes one line_tile_backward launch takes (csrc/line_tile.cu).
MAX_CLASSES = 16


def strength_coef(d, Z):
    """The strength coefficient SIGCTE*ratio/(mass*Z) per (layer, isotope),
    (nl, niso) (pallas_lbl.py:123-124)."""
    return (SIGCTE * d["iso_ratio"][None, :] /
            (d["iso_mass"][None, :] * Z.T)).contiguous()


def width_tables(d, temps, densities, mol_mass, mol_radius,
                 unit_density: bool = False):
    """Per-(layer, isotope) Lorentz width ``alphal``, Doppler factor
    ``alphad_f`` (x wavenumber = alphaD) and absorber density ``densm``,
    each (nl, niso) (pallas_lbl.py:117-125).  ``unit_density`` (the
    opacity-grid build, fast._prep_layers(unit_density=True),
    fast.py:338-372): ``densm`` is 1, the widths still see the
    densities."""
    imol = d["iso_imol"].long()
    alphal, alphad_f = _layer_widths(temps, densities, d["iso_mass"], imol,
                                     mol_mass, mol_radius)
    densm = densities.T[:, imol]
    return {"alphal": alphal.contiguous(), "alphad_f": alphad_f.contiguous(),
            "densm": torch.ones_like(densm) if unit_density else densm}


def plain_kmax(d, temps, coef0, floor: float = -torch.inf):
    """Per-layer species-collapsed maximum line strength (nl,) over the
    full line list (pallas_lbl.py:127-133): the max of ``floor`` and,
    over lines, k0 = gf e^(-c2 El/T) (1 - e^(-c2 nu/T)) coef0[layer, iso].
    The default floor -inf is jnp.max's (pallas_lbl.py:133); the banded
    path's scan starts its carry at 0 (fast._kmax_scan, fast.py:413-418).
    The plain PyTorch version of :func:`layer_kmax`."""
    T = temps[:, None]
    nlines = d["all_wavn"].shape[0]
    kmax = torch.full_like(temps, floor)
    for a in range(0, nlines, KMAX_CHUNK):
        w = d["all_wavn"][None, a:a + KMAX_CHUNK]
        s = (d["all_gf"][None, a:a + KMAX_CHUNK] *
             torch.exp(-EXPCTE * d["all_elow"][None, a:a + KMAX_CHUNK] / T) *
             (1.0 - torch.exp(-EXPCTE * w / T)))
        k = s * coef0[:, d["all_iso"][a:a + KMAX_CHUNK].long()]
        kmax = torch.maximum(kmax, k.amax(dim=1))
    return kmax


def constant_kmax(kmax_override, temps):
    """An external per-layer kmax (nl,) as a constant in the dtype and on
    the device of ``temps``: no gradient flows into it (fast.py:373-374;
    kmax only sets which lines are kept)."""
    return torch.as_tensor(kmax_override).detach().to(dtype=temps.dtype,
                                                      device=temps.device)


def layer_tables(d, temps, densities, Z, mol_mass, mol_radius,
                 kmax_override=None):
    """The per-layer tables of the line-tile computation
    (pallas_lbl.py:111-133): :func:`width_tables`, ``coef0``
    (:func:`strength_coef`) and the per-layer ``kmax``
    (:func:`plain_kmax`, or ``kmax_override``: :func:`constant_kmax`)."""
    coef0 = strength_coef(d, Z)
    kmax = (plain_kmax(d, temps, coef0) if kmax_override is None else
            constant_kmax(kmax_override, temps))
    return {**width_tables(d, temps, densities, mol_mass, mol_radius),
            "coef0": coef0, "kmax": kmax}


def block_lines(d, t0: int, t1: int, n: int, tab, temps, ethresh: float):
    """fast._block_lines (fast.py:515) on rows t0:t1 of the line tensors
    ``d``, their first n lines: the line rows wv, el, gf, iso (long) and
    mask, each (tc, L), and per (layer, tile, line), each (nl, tc, L),
    the strength chain's parts e1, e2, s, coef, k0, the isotope tables'
    values dd (density), aL, aDf, and ``keep`` (unmasked, k0 >= ethresh
    kmax) with kd = k0 where kept, else 0."""
    T = temps[:, None, None]
    P = {k: d[k][t0:t1, :n] for k in ("wavn", "elow", "gf", "mask")}
    wv, el, iso = P["wavn"], P["elow"], d["iso"][t0:t1, :n].long()
    e1 = torch.exp(-EXPCTE * el / T)
    e2 = torch.exp(-EXPCTE * wv / T)
    s = P["gf"] * e1 * (1.0 - e2)
    coef = tab["coef0"][:, iso]
    k0 = s * coef
    keep = P["mask"] & (k0 >= (ethresh * tab["kmax"])[:, None, None])
    return dict(wv=wv, el=el, gf=P["gf"], iso=iso, mask=P["mask"], e1=e1,
                e2=e2, s=s, coef=coef, k0=k0, dd=tab["densm"][:, iso],
                aL=tab["alphal"][:, iso], aDf=tab["alphad_f"][:, iso],
                keep=keep, kd=torch.where(keep, k0, 0.0))


def _line_chunks(plan: FastPlan, d, tab, temps, ethresh: float,
                 nwidth: float):
    """Walk the tiles in chunks whose (layer, tile, bin, line) volume stays
    under PLAIN_ELEMENTS elements.  Yields (t0, t1, L, k, aD, wing) for
    tiles t0:t1: L, :func:`block_lines`' dict of their first lines (L
    stops at the chunk's longest line list: the padding after it is
    masked); per (layer, tile, line), each (nl, tc, L): the line strength
    x density k, 0 where not kept, alphaD, and the wing half-width
    nwidth * max(alphaD, alphaL)."""
    nl = temps.shape[0]
    ntiles, lmax = d["wavn"].shape
    step = max(1, PLAIN_ELEMENTS[temps.device.type] //
               max(1, nl * plan.tw * lmax))
    for t0 in range(0, ntiles, step):
        t1 = min(ntiles, t0 + step)
        n = max(1, int(d["mask"][t0:t1].sum(dim=1).max()))
        L = block_lines(d, t0, t1, n, tab, temps, ethresh)
        aD = L["aDf"] * L["wv"]
        yield (t0, t1, L, L["kd"] * L["dd"], aD,
               nwidth * torch.maximum(aD, L["aL"]))


def _bin_origin(tile, tw: int, wn_i: float, dwn: float, bins_first: bool):
    """(wa, wb), each (tc,) in the dtype of ``tile`` (the global tile
    indices, as floats): the kernel's bin wavenumber is
    (wa + dwn*bin) + wb.  The unbanded path rounds as the Pallas kernel
    does, wa = wn_i + dwn*(tile*tw) and wb = 0 (pallas_lbl.py:59); with
    ``bins_first``, as fast._run_tiles does, wa = wn_i and
    wb = dwn*(tile*tw) (fast.py:723, 771)."""
    toff = dwn * (tile * tw)
    if bins_first:
        return torch.full_like(tile, wn_i), toff
    return wn_i + toff, torch.zeros_like(tile)


def _tile_ids(gidx, t0: int, t1: int, dtype, device):
    """Global tile indices of rows t0:t1 of the line tensors, as floats
    (``gidx`` None: the rows are the tiles)."""
    if gidx is None:
        return torch.arange(t0, t1, device=device).to(dtype)
    return torch.as_tensor(gidx[t0:t1], device=device).to(dtype)


def _tile_chunks(plan: FastPlan, d, tab, temps, wn_i: float, dwn: float,
                 ethresh: float, nwidth: float, gidx=None,
                 bins_first: bool = False):
    """Walk the tiles in chunks (:func:`_line_chunks`).  Yields (t0, t1,
    L, k, x_raw, y, inv, use) for tiles t0:t1: :func:`block_lines`' dict
    L; the line strength x density k (nl, tc, L), 0 where the line is
    masked or dropped by the ethresh cut; the Voigt arguments x_raw (nl,
    tc, tw, L), which fast._block_primal clamps at 1e8, and y, and
    1/alphaD inv, both (nl, tc, 1, L); and ``use`` (nl, tc, tw, L), a
    kept line inside its wing.  ``gidx``: the global tile index of each
    row of ``d`` (None: row i is tile i); ``bins_first``: see
    :func:`_bin_origin`."""
    tw = plan.tw
    dtype, device = d["wavn"].dtype, d["wavn"].device
    bins = torch.arange(tw, device=device).to(dtype)
    for t0, t1, L, k, aD, wing in _line_chunks(plan, d, tab, temps, ethresh,
                                               nwidth):
        wv = L["wv"]
        inv = 1.0 / aD
        y = SQRTLN2 * L["aL"] * inv
        # The kernel's bin wavenumber, (wa + dwn*bin) + wb:
        wa, wb = _bin_origin(_tile_ids(gidx, t0, t1, dtype, device), tw,
                             wn_i, dwn, bins_first)
        wn_col = (wa[:, None] + (dwn * bins)[None, :]) + wb[:, None]
        dist = (wn_col[:, :, None] - wv[:, None, :]).abs()  # (tc, tw, L)
        inv = inv[:, :, None, :]
        use = ((dist[None] <= wing[:, :, None, :]) &
               L["keep"][:, :, None, :])
        yield (t0, t1, L, k, SQRTLN2 * dist[None] * inv, y[:, :, None, :],
               inv, use)


def _find_runs(wa, wb, wv, wing, dwn: float, tw: int):
    """The run [b0, b1] of each line's bins inside its wing, the way the
    kernel finds it (csrc/line_tile.cu:find_run): seeded at the bin
    nearest the line, clamped to the tile; if that bin is out, walk toward
    the line until a bin is in, or the walk passes the line or the tile;
    then extend both ends while the next bin is in.  Bin b lies at
    (wa + dwn*b) + wb (:func:`_bin_origin`); wa, wb (tc,), wv (tc, L),
    wing (nl, tc, L) -> b0, b1 (int64) and ``found`` (bool), each
    (nl, tc, L)."""
    wa = wa[None, :, None]
    wb = wb[None, :, None]
    wn0 = wa + wb
    wv = wv[None]

    def wn(b):
        return (wa + dwn * b.to(wv.dtype)) + wb

    def inside(b):
        return (wn(b) - wv).abs() <= wing

    seed = torch.nan_to_num(torch.round((wv - wn0) * (1.0 / dwn)), nan=0.0)
    s = seed.clamp(0, tw - 1).long().expand(wing.shape).clone()
    found = inside(s)
    step = torch.where(wn(s) < wv, 1, -1)
    walking = ~found
    while bool(walking.any()):
        s = torch.where(walking, s + step, s)
        walking &= (s >= 0) & (s < tw)
        w = wn(s.clamp(0, tw - 1))
        hit = walking & ((w - wv).abs() <= wing)
        found |= hit
        walking &= ~hit & torch.where(step > 0, w < wv, w > wv)
    b0, b1 = s.clone(), s.clone()
    grow = found & (b0 > 0)
    while bool(grow.any()):
        grow &= inside((b0 - 1).clamp(min=0))
        b0 -= grow.long()
        grow &= b0 > 0
    grow = found & (b1 < tw - 1)
    while bool(grow.any()):
        grow &= inside((b1 + 1).clamp(max=tw - 1))
        b1 += grow.long()
        grow &= b1 < tw - 1
    return b0, b1, found


def bin_runs(plan: FastPlan, d, tab, temps, wn_i: float, dwn: float,
             ethresh: float, nwidth: float, gidx=None,
             bins_first: bool = False):
    """The (layer, tile, line) entries of the kernel's design, by chunks
    of tiles: yields (t0, t1, b0, b1, reach, live), each (nl, tc, L) but
    t0, t1; ``reach`` is an unmasked line whose wing reaches a bin of the
    tile (the kernel computes its strength chain), ``live`` one of those
    that is kept, [b0, b1] the run of the tile's bins it reaches
    (:func:`_find_runs`).  The bins of the live runs are exactly ``use``
    of :func:`_tile_chunks` (same ``gidx`` and ``bins_first``)."""
    dtype, device = d["wavn"].dtype, d["wavn"].device
    for t0, t1, L, _, _, wing in _line_chunks(plan, d, tab, temps, ethresh,
                                              nwidth):
        wa, wb = _bin_origin(_tile_ids(gidx, t0, t1, dtype, device),
                             plan.tw, wn_i, dwn, bins_first)
        b0, b1, found = _find_runs(wa, wb, L["wv"], wing, dwn, plan.tw)
        reach = found & L["mask"][None]
        yield t0, t1, b0, b1, reach, L["keep"] & found


def run_counts(plan: FastPlan, d, tab, temps, wn_i: float, dwn: float,
               ethresh: float, nwidth: float, gidx=None,
               bins_first: bool = False) -> dict:
    """The kernel's own work on this data (:func:`bin_runs`):
    ``chains``, the (layer, tile, line) entries whose wing reaches the
    tile, each a strength chain; ``live``, the kept ones; ``pairs``, the
    (layer, bin, line) pairs of their runs, each a Voigt evaluation."""
    out = {"chains": 0, "live": 0, "pairs": 0}
    for *_, b0, b1, reach, live in bin_runs(plan, d, tab, temps, wn_i, dwn,
                                            ethresh, nwidth, gidx,
                                            bins_first):
        out["chains"] += int(reach.sum())
        out["live"] += int(live.sum())
        out["pairs"] += int(torch.where(live, b1 - b0 + 1, 0).sum())
    return out


def plain_line_tiles(plan: FastPlan, d, tab, temps, wn_i: float,
                     dwn: float, ethresh: float, nwidth: float, gidx=None,
                     bins_first: bool = False):
    """The line-tile function on the line tensors ``d`` (nt, lmax) and the
    per-layer tables ``tab`` of the layers of ``temps``: (nl, nt, tw), for
    each layer, tile and bin the sum over the tile's kept lines inside
    their wing of k K(x, y) / alphaD, with K the Voigt function of the
    plan's ``wfn_tag`` (fast._block_primal without a line weight,
    fast.py:554).
    The plain PyTorch version of :func:`line_tile_extinction`, walking
    the tiles in chunks (:func:`_tile_chunks`)."""
    voigt = FAR_KERNELS[plan.wfn_tag]
    nl = temps.shape[0]
    ntiles, tw = d["wavn"].shape[0], plan.tw
    out = torch.zeros((nl, ntiles, tw), dtype=d["wavn"].dtype,
                      device=d["wavn"].device)
    for t0, t1, _, k, x_raw, y, inv, use in _tile_chunks(
            plan, d, tab, temps, wn_i, dwn, ethresh, nwidth, gidx,
            bins_first):
        prof = voigt(torch.clamp_max(x_raw, 1e8), y) * inv
        out[:, t0:t1] = (torch.where(use, prof, 0.0) *
                         k[:, :, None, :]).sum(dim=3)
    return out


def voigt_bin_sums(wraw, x_raw, y, B):
    """The three bin sums of fast._block_val_bwd (fast.py:647-651) before
    their line factors: with (Re w, Im w) = wraw(x, y), x = min(x_raw,
    1e8), and the Faddeeva partials Kx', Ky' (voigt.faddeeva_partials),
    sums over the bin axis (2) of B wr, B (wr + x Kx' [x_raw < 1e8] +
    y Ky') and B Ky'.  The pair w, the partials and the per-pair terms
    are computed in :data:`PAIR_DTYPE` (None: the arguments' dtype, as
    JAX and the backward kernels compute them), the
    sums over pairs in float64.  In float32, every operation in the order
    the kernels' pair functions take (csrc/voigt.cuh), so that a kernel's
    terms equal these bit for bit."""
    dt = PAIR_DTYPE or x_raw.dtype
    x = torch.clamp_max(x_raw, 1e8).to(dt)
    y = y.to(dt).expand_as(x)
    B = B.to(dt)
    wr, wi = wraw(x, y)
    kxp, kyp = faddeeva_partials(x, y, wr, wi)
    free = torch.where(x_raw < 1e8, x * kxp, 0.0)
    return tuple(t.double().sum(dim=2) for t in (
        B * wr, B * (wr + free + y * kyp), B * kyp))


def chain_vjp(L, inv, k, sums, temps, grads, wl=None):
    """Chain one chunk's bin sums (:func:`voigt_bin_sums`) to the
    cotangents of the layer temperatures and of the (nl, niso) tables, as
    fast._block_val_bwd does (fast.py:651-677), and add them into
    ``grads`` ({"temps", "coef0", "densm", "alphal", "alphad_f"}).  ``L``
    is :func:`block_lines`' dict, ``inv`` = 1/alphaD and ``k`` the line
    strength x density (x ``wl``, a decimated shell's halo weight), each
    (nl, tc, L).  kmax gets no cotangent (it only sets ``keep``).  In
    float64 (``grads`` are float64 sums, :func:`zero_grads`), as the
    backward kernels compute it."""
    C = SQRTLN2PI
    s1, s2, s3 = sums
    L = {k: v.double() if v.is_floating_point() else v for k, v in L.items()}
    inv, k, temps = inv.double(), k.double(), temps.double()
    wl = None if wl is None else wl.double()
    keep, wv = L["keep"], L["wv"]
    gk = torch.where(keep, C * inv * s1, 0.0)
    g_inv = torch.where(keep, C * k * s2, 0.0)
    gaL = torch.where(keep, (C * SQRTLN2) * inv * inv * k * s3, 0.0)
    gaDf = -g_inv * inv * inv * wv
    dd = L["dd"] if wl is None else L["dd"] * wl
    gdd = gk * L["kd"]
    gk0 = gk * dd
    gs = gk0 * L["coef"]
    T = temps[:, None, None]
    gT = gs * (EXPCTE / (T * T)) * L["gf"] * L["e1"] * (
        L["el"] * (1.0 - L["e2"]) - wv * L["e2"])
    grads["temps"] += gT.sum(dim=(1, 2))
    nl = temps.shape[0]
    idx = L["iso"].expand(nl, *L["iso"].shape).reshape(nl, -1)
    for name, v in (("coef0", gk0 * L["s"]),
                    ("densm", gdd if wl is None else gdd * wl),
                    ("alphal", gaL), ("alphad_f", gaDf)):
        grads[name].scatter_add_(1, idx, v.reshape(nl, -1))


def zero_grads(tab, temps) -> dict:
    """Zero float64 sums for the cotangents of ``temps`` and of the
    (nl, niso) tables."""
    f64 = dict(dtype=torch.float64)
    return {"temps": torch.zeros_like(temps, **f64),
            **{k: torch.zeros_like(tab[k], **f64)
               for k in ("coef0", "densm", "alphal", "alphad_f")}}


def cast_grads(grads: dict, dtype) -> dict:
    """The float64 sums of :func:`zero_grads` cast once to ``dtype``."""
    return {k: v.to(dtype) for k, v in grads.items()}


def plain_line_tiles_vjp(plan: FastPlan, d, tab, temps, g, wn_i: float,
                         dwn: float, ethresh: float, nwidth: float,
                         gidx=None, bins_first: bool = False,
                         grads=None) -> dict:
    """The VJP of :func:`plain_line_tiles`: the cotangent ``g`` (nl, nt,
    tw) of its output -> the cotangents of ``temps`` (nl,) and of the
    tables ``coef0``, ``densm``, ``alphal`` and ``alphad_f`` (nl, niso),
    float64 sums (:func:`zero_grads`; added into ``grads`` when given).
    fast._block_val_bwd without a line weight (fast.py:608-680): per chunk
    of tiles it recomputes x, y, k and w and keeps no residuals; the
    geometry (kept lines, wing masks, x) and the pair w in the tensors'
    dtype (:func:`voigt_bin_sums`), the sums and the chain in float64.
    The plain PyTorch version of :func:`line_tile_backward`."""
    grads = zero_grads(tab, temps) if grads is None else grads
    for t0, t1, L, k, x_raw, y, inv, use in _tile_chunks(
            plan, d, tab, temps, wn_i, dwn, ethresh, nwidth, gidx,
            bins_first):
        B = torch.where(use, g[:, t0:t1, :, None], 0.0)
        chain_vjp(L, inv[:, :, 0, :], k, voigt_bin_sums(
            RAW_W[plan.wfn_tag], x_raw, y, B), temps, grads)
    return grads


def plan_classes(plan: FastPlan, d):
    """[(line tensors, global tile indices (numpy int32) or None)] per
    tile class of ``plan`` (one entry when it has no classes)."""
    if plan.class_tiles is None:
        return [({k: d[k] for k in ("wavn", "elow", "gf", "iso", "mask")},
                 None)]
    return list(zip(d["classes"], plan.class_tiles))


def plain_classes(plan: FastPlan, classes, temps, fn):
    """A plan's function over all its tiles from its classes [(line
    tensors, global tiles (numpy) or None)]: ``fn(dc, gidx)`` gives a
    class's (nl, nt_c, tw), placed at its tiles -> (nl, ntiles * tw)."""
    nl = temps.shape[0]
    full = torch.zeros((nl, plan.ntiles, plan.tw), dtype=temps.dtype,
                       device=temps.device)
    for dc, gidx in classes:
        val = fn(dc, gidx)
        if gidx is None:
            full = val
        else:
            full[:, torch.as_tensor(gidx, device=full.device).long()] = val
    return full.reshape(nl, -1)


def plain_extinction(plan: FastPlan, d, temps, densities, Z, mol_mass,
                     mol_radius, wn_i: float, dwn: float, ethresh: float,
                     nwidth: float, kmax_override=None):
    """Extinction (nlayer, n_coarse) on the unbanded plan: the plain
    PyTorch version of :func:`kernel_extinction`, on the tensors'
    device (:func:`layer_tables`, :func:`plain_line_tiles`, class by
    class on a plan with tile classes)."""
    tab = layer_tables(d, temps, densities, Z, mol_mass, mol_radius,
                       kmax_override)
    out = plain_classes(plan, plan_classes(plan, d), temps, lambda dc, gidx:
                        plain_line_tiles(plan, dc, tab, temps, wn_i, dwn,
                                         ethresh, nwidth, gidx=gidx))
    return out[:, :plan.n_coarse]


def work_counts(plan: FastPlan, d, tab, temps, wn_i: float, dwn: float,
                ethresh: float, nwidth: float, gidx=None,
                bins_first: bool = False) -> dict:
    """The work the line-tile function needs on this data, whatever the
    design: ``layer_lines``, one strength and width chain per (layer,
    line) of the line list; and the Voigt evaluations of kept lines inside
    their wing, one per (layer, bin, line), by Humlicek region (``II``,
    ``III``, ``IV``)."""
    out = {"layer_lines": temps.shape[0] * d["all_wavn"].shape[0],
           "II": 0, "III": 0, "IV": 0}
    for *_, x_raw, y, _, use in _tile_chunks(plan, d, tab, temps, wn_i,
                                             dwn, ethresh, nwidth, gidx,
                                             bins_first):
        for name, region in zip(("II", "III", "IV"), humlicek_regions(
                torch.clamp_max(x_raw, 1e8), y)):
            out[name] += int((use & region).sum())
    return out


def fold_batch(x, dim, B: int):
    """A vmapped argument with its batch at ``dim`` (None: not batched,
    shared by every member) as B times its rows: (B * n, ...), member
    after member (the layout of forward_batch's pseudo-layers)."""
    x = x.movedim(dim, 0) if dim is not None else x.expand(B, *x.shape)
    return x.reshape(B * x.shape[1], *x.shape[2:])


class LineExtinction(torch.autograd.Function):
    """The line extinction as a differentiable function of the layer
    temperatures and the four (nl, niso) tables ``coef0``, ``densm``,
    ``alphal`` and ``alphad_f`` (the counterpart of JAX's custom VJP
    ``fast._block_val``, fast.py:577-680, around a whole plan).  ``op``
    (:class:`TilesOp`, or banded.BandedOp) gives the per-layer kmax
    (no gradient: it only sets which lines are kept, fast.py:677), the
    forward and the backward; ``grad`` says whether a backward will
    follow (the forward then keeps what ``op.backward`` needs: the
    decimated shells' clip masks).  The tables' own dependence on T and
    the densities stays torch ops, so autograd chains it, as JAX does
    around ``_block_val``.  The forward returns (extinction, kmax, the
    op's state), the last two without gradient; it saves its inputs and
    kmax (nl,), no element-sized residuals: the backward recomputes x, y
    and w.  Autograd through the plain forward (plain_extinction,
    banded.plain_banded_extinction) would store the whole evaluation
    volume and is kept only as the tests' oracle.

    torch.func transforms it: the function is independent per layer, so
    its vmap rule folds the batch into pseudo-layers, through
    ``op.batched(B)`` (the unbanded plan as it is; the banded plan's
    batched view, as forward_batch takes it), and the backward runs
    through :class:`LineExtinctionVjp`, whose vmap rule does the same."""

    @staticmethod
    def forward(op, grad: bool, temps, coef0, densm, alphal, alphad_f):
        tab = {"alphal": alphal, "alphad_f": alphad_f, "densm": densm,
               "coef0": coef0}
        with span("kmax"):
            tab["kmax"] = op.kmax(temps, coef0)
        with span("line_tiles"):
            out, state = op.forward(tab, temps, grad=grad)
        return out, tab["kmax"], state

    @staticmethod
    def setup_context(ctx, inputs, output):
        op, _, temps, coef0, densm, alphal, alphad_f = inputs
        _, kmax, state = output
        ctx.mark_non_differentiable(kmax)
        ctx.set_materialize_grads(False)   # no zero cotangent for kmax
        ctx.op, ctx.state = op, state
        ctx.save_for_backward(temps, coef0, densm, alphal, alphad_f, kmax)

    @staticmethod
    def backward(ctx, g, _kmax, _state):
        return (None, None, *LineExtinctionVjp.apply(
            ctx.op, ctx.state, *ctx.saved_tensors, g))

    @staticmethod
    def vmap(info, in_dims, op, grad, *args):
        B = info.batch_size
        out, kmax, state = LineExtinction.apply(
            op.batched(B), grad,
            *(fold_batch(x, d, B) for x, d in zip(args, in_dims[2:])))
        return ((out.reshape(B, -1, out.shape[1]), kmax.reshape(B, -1),
                 state), (0, 0, None))


class LineExtinctionVjp(torch.autograd.Function):
    """The backward of :class:`LineExtinction`: (temps, the four tables,
    kmax, the cotangent g of the extinction) -> the cotangents of temps
    and of the tables (``op.backward``, the backward kernels or the
    plain VJPs).  Its vmap rule folds the batch into pseudo-layers; it
    has no derivative of its own."""

    @staticmethod
    def forward(op, state, temps, coef0, densm, alphal, alphad_f, kmax, g):
        tab = {"alphal": alphal, "alphad_f": alphad_f, "densm": densm,
               "coef0": coef0, "kmax": kmax}
        with span("line_tiles.bwd"):
            gr = op.backward(tab, temps, g.contiguous(), state)
        return (gr["temps"], gr["coef0"], gr["densm"], gr["alphal"],
                gr["alphad_f"])

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *_):
        raise NotImplementedError("the line extinction has no second "
                                  "derivative")

    @staticmethod
    def vmap(info, in_dims, op, state, *args):
        B = info.batch_size
        out = LineExtinctionVjp.apply(
            op.batched(B), state,
            *(fold_batch(x, d, B) for x, d in zip(args, in_dims[2:])))
        return (tuple(o.reshape(B, -1, *o.shape[1:]) for o in out),
                (0,) * len(out))


def line_extinction(op, temps, coef0, densm, alphal, alphad_f):
    """:class:`LineExtinction` of ``op`` on these tensors: the extinction
    (nl, n_coarse); the forward keeps the backward's state when a
    gradient can follow (grad mode on and an input that requires it)."""
    args = (temps, coef0, densm, alphal, alphad_f)
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in args)
    return LineExtinction.apply(op, grad, *args)[0]


class TilesOp:
    """The unbanded plan's line extinction for :class:`LineExtinction`:
    ``layer_kmax`` (floor -inf), or ``kmax_override`` (a constant), then
    with ``kernel`` one ``line_tile_extinction`` launch per tile class
    (one for a plan without classes; a shard of the plan,
    parallel/sharded.py, has its tiles as classes) and one
    ``line_tile_backward`` launch; else their plain versions
    (:func:`plain_kmax`, :func:`plain_line_tiles`,
    :func:`plain_line_tiles_vjp`)."""

    def __init__(self, plan: FastPlan, d, kw: dict, kernel: bool,
                 kmax_override=None, band=None):
        self.plan, self.d, self.kw, self.kernel = plan, d, kw, kernel
        self.kmax_override = kmax_override
        self.classes = plan_classes(plan, d)
        self.band = None
        if kernel:
            self.band = band if band is not None else tiles_index(plan, d)

    def batched(self, B: int):
        """The op over B profiles' layers one after another: the same
        (the unbanded plan has no per-layer parts); an external kmax is
        one profile's and refuses a batch."""
        if self.kmax_override is not None:
            raise ValueError("kmax_override holds one profile's layers")
        return self

    def kmax(self, temps, coef0):
        if self.kmax_override is not None:
            return constant_kmax(self.kmax_override, temps)
        return (layer_kmax if self.kernel else plain_kmax)(self.d, temps,
                                                           coef0)

    def forward(self, tab, temps, grad: bool):
        if self.kernel:
            out = None
            for plan, dc, _, t in self.band.units:
                out = line_tile_extinction(plan, dc, tab, temps, tiles=t,
                                           out=out, **self.kw)
            return out, None
        out = plain_classes(self.plan, self.classes, temps, lambda dc, gidx:
                            plain_line_tiles(self.plan, dc, tab, temps,
                                             gidx=gidx, **self.kw))
        return out[:, :self.plan.n_coarse], None

    def backward(self, tab, temps, g, state):
        if self.kernel:
            return acc_grads(line_tile_backward(self.band, tab, temps, g,
                                                **self.kw), temps.dtype)
        grads = zero_grads(tab, temps)
        gt = tile_cotangent(g, self.plan)
        for dc, gidx in self.classes:
            gc = gt if gidx is None else gt[:, torch.as_tensor(
                gidx, device=gt.device).long()]
            plain_line_tiles_vjp(self.plan, dc, tab, temps, gc, gidx=gidx,
                                 grads=grads, **self.kw)
        return cast_grads(grads, temps.dtype)


def tiles_index(plan: FastPlan, d) -> LineBand:
    """The unbanded plan's kernel launches as one :class:`LineBand`: each
    tile class's line tensors and its int32 global tiles on the tensors'
    device (made once per model, so that a step copies nothing from the
    host)."""
    device = d["all_wavn"].device
    return LineBand([(plan, dc, g, None if g is None else
                      torch.as_tensor(g, dtype=torch.int32, device=device))
                     for dc, g in plan_classes(plan, d)])


def tile_cotangent(g, plan: FastPlan):
    """A cotangent (nl, n_coarse) of a plan's output as (nl, ntiles, tw):
    zero on the last tile's bins past n_coarse."""
    pad = plan.ntiles * plan.tw - g.shape[1]
    return torch.nn.functional.pad(g, (0, pad)).reshape(
        g.shape[0], plan.ntiles, plan.tw)


def kernel_extinction(plan: FastPlan, d, temps, densities, Z, mol_mass,
                      mol_radius, wn_i: float, dwn: float, ethresh: float,
                      nwidth: float, use_kernel: bool = True,
                      kmax_override=None, index=None):
    """Extinction (nlayer, n_coarse) through the CUDA kernels,
    differentiable in temps, densities and Z (:class:`LineExtinction`).

    Same arguments as pallas_extinction: the plan, its device arrays
    (fast.fast_device_arrays), layer temperatures (cgs), densities
    (nmol, nl), partition functions Z (niso, nl) and the molecules'
    masses and radii.  A CUDA tensor launches :func:`layer_kmax` and the
    line-tile kernel, which take float32 only (and ``line_tile_backward``
    for a gradient); a CPU tensor, or ``use_kernel=False``, takes their
    plain versions (the forward equals :func:`plain_extinction`).
    ``kmax_override``: an external per-layer kmax (nl,) in place of the
    scan (the multi-process bands' global kmax), a constant.  ``index``:
    :func:`tiles_index` of the plan and ``d`` (made here when None).
    """
    kernel = use_kernel and d["all_wavn"].device.type == "cuda"
    with span("tables"):
        coef0 = strength_coef(d, Z)
        tab = width_tables(d, temps, densities, mol_mass, mol_radius)
    op = TilesOp(plan, d, dict(wn_i=wn_i, dwn=dwn, ethresh=ethresh,
                               nwidth=nwidth), kernel, kmax_override, index)
    return line_extinction(op, temps, coef0, tab["densm"], tab["alphal"],
                           tab["alphad_f"])


def _check_cuda(fn: str, args: dict, ints=("iso",), u8=("clip",)):
    """Raise unless every tensor of ``args`` is on one CUDA device and
    float32 (int32 for ``ints``, uint8 for ``u8``, bool for ``mask``);
    returns the device.  A kernel reads its inputs' values: the gradient
    comes from the backward kernels (:class:`LineExtinction`)."""
    device = next(iter(args.values())).device
    if device.type != "cuda":
        raise ValueError(f"{fn} runs on CUDA tensors, not {device}")
    for name, t in args.items():
        want = (torch.int32 if name in ints else
                torch.uint8 if name in u8 else
                torch.bool if name == "mask" else torch.float32)
        if t.dtype != want:
            raise TypeError(f"{fn}: {name} is {t.dtype}, the kernel takes "
                            f"{want}")
        if t.device != device:
            raise ValueError(f"{fn}: {name} is on {t.device}, not "
                             f"{device}")
    return device


def layer_kmax(d, temps, coef0, floor: float = -torch.inf):
    """Launch ``layer_kmax`` (csrc/line_tile.cu): the per-layer maximum
    line strength (nl,) float32 over the full line list of ``d``, at the
    layer temperatures ``temps`` (nl,) and strength coefficients
    ``coef0`` (nl, niso), and at least ``floor`` — :func:`plain_kmax` on
    the card.  Raises on any other device, type or shape, and when the
    launch fails."""
    from transit_tpu_torch.opacities._build import load_library

    lines = {k: d[k] for k in ("all_wavn", "all_elow", "all_gf", "all_iso")}
    args = {**lines, "temps": temps, "coef0": coef0}
    device = _check_cuda("layer_kmax", args, ints=("all_iso",))
    nlines = lines["all_wavn"].shape[0]
    nl = temps.shape[0]
    for name, t in lines.items():
        if tuple(t.shape) != (nlines,):
            raise ValueError(f"layer_kmax: {name} has shape "
                             f"{tuple(t.shape)}")
    if coef0.dim() != 2 or coef0.shape[0] != nl or temps.dim() != 1:
        raise ValueError(f"layer_kmax: temps {tuple(temps.shape)} and "
                         f"coef0 {tuple(coef0.shape)} do not match")
    if coef0.shape[1] > 64:
        raise ValueError(f"layer_kmax: {coef0.shape[1]} isotopes; the "
                         f"kernel keeps at most 64 coef0 columns in shared "
                         f"memory")
    kmax = torch.full((nl,), floor, dtype=torch.float32, device=device)
    if nl == 0 or nlines == 0:
        return kmax
    args = {k: v.contiguous() for k, v in args.items()}
    with torch.cuda.device(device):
        lib = load_library()
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.layer_kmax(
            *(ctypes.c_void_p(args[k].data_ptr())
              for k in ("all_wavn", "all_elow", "all_gf", "all_iso", "temps",
                        "coef0")),
            ctypes.c_void_p(kmax.data_ptr()), nlines, nl, coef0.shape[1],
            -EXPCTE, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"layer_kmax failed to launch: CUDA error {err}")
    layer_kmax.launches += 1
    log.launched("layer_kmax_kernel")
    return kmax


def _check_lines(fn: str, plan: FastPlan, d, tiles):
    """Check one tile class's line tensors ``d`` and global ``tiles``
    against the plan (shapes, tile width, Voigt function): returns
    (ntiles, lmax)."""
    ntiles, lmax = d["wavn"].shape
    if tiles is None and (plan.ntiles != ntiles or plan.lmax != lmax):
        raise ValueError("line tensors do not match the plan")
    if tiles is not None and tuple(tiles.shape) != (ntiles,):
        raise ValueError(f"{fn}: one tile index per row")
    for name in ("wavn", "elow", "gf", "iso", "mask"):
        if tuple(d[name].shape) != (ntiles, lmax):
            raise ValueError(f"{fn}: {name} has shape "
                             f"{tuple(d[name].shape)}")
    if plan.tw > 512:
        raise ValueError(f"{fn}: tile width {plan.tw} > 512")
    if plan.wfn_tag not in ("w4", "r2"):
        raise ValueError(f"{fn}: Voigt function {plan.wfn_tag!r}; the "
                         f"kernel has w4 and r2")
    return ntiles, lmax


def _check_tables(fn: str, tab, temps, rows):
    """Check a line-tile launch's per-layer arguments (the tables (nl,
    niso), kmax and temps (nl,), 1-d rows): returns (nl, niso, nrows)."""
    nl = temps.shape[0]
    niso = tab["alphal"].shape[1]
    for name in ("alphal", "alphad_f", "coef0", "densm"):
        if tuple(tab[name].shape) != (nl, niso):
            raise ValueError(f"{fn}: {name} has shape "
                             f"{tuple(tab[name].shape)}")
    if tuple(tab["kmax"].shape) != (nl,) or temps.dim() != 1:
        raise ValueError(f"{fn}: kmax and temps must be (nl,)")
    if rows is not None and rows.dim() != 1:
        raise ValueError(f"{fn}: rows must be 1-d")
    return nl, niso, nl if rows is None else rows.shape[0]


def _line_launch(fn: str, plan: FastPlan, d, tab, temps, tiles, rows):
    """Check one :func:`line_tile_extinction` launch's arguments: returns
    (device, its tensors made contiguous, nl, niso, ntiles, lmax,
    nrows)."""
    lines = {k: d[k] for k in ("wavn", "elow", "gf", "iso", "mask")}
    idx = {k: v for k, v in (("tiles", tiles), ("rows", rows))
           if v is not None}
    args = {**lines, **tab, "temps": temps, **idx}
    device = _check_cuda(fn, args, ints=("iso", "tiles", "rows"))
    ntiles, lmax = _check_lines(fn, plan, d, tiles)
    nl, niso, nrows = _check_tables(fn, tab, temps, rows)
    return (device, {k: v.contiguous() for k, v in args.items()}, nl, niso,
            ntiles, lmax, nrows)


def line_tile_extinction(plan: FastPlan, d, tab, temps, wn_i: float,
                         dwn: float, ethresh: float, nwidth: float,
                         stats=None, *, tiles=None, rows=None, out=None,
                         accumulate: bool = False, bins_first: bool = False):
    """Launch ``line_tile_extinction`` (csrc/line_tile.cu) on the line
    tiles ``d`` and the per-layer tables ``tab`` (:func:`layer_tables`)
    -> extinction (nlayer, n_coarse), float32 on the tiles' CUDA device.

    ``tiles``: int32 global tile index of each row of ``d`` (one tile
    class; None: row i is tile i of the plan).  ``rows``: int32 layer
    indices into ``temps`` and ``tab`` that the launch computes (None:
    all).  ``out``: the (nlayer, n_coarse) float32 output to write in
    place, the launch's (row, tile) block only; ``accumulate`` adds the
    launch's sums to it.  ``bins_first``: the bin wavenumber's rounding
    (:func:`_bin_origin`).  The Voigt function is the plan's
    ``wfn_tag``.  ``stats``, a (3,) int64 tensor on the card, gets
    the strength chains computed, the live (layer, tile, line) entries
    and the (layer, bin, line) pairs evaluated added to it
    (:func:`run_counts` counts the same on the host).  Raises on any
    other device, type or shape, and when the launch fails."""
    from transit_tpu_torch.opacities._build import load_library

    device, args, nl, niso, ntiles, lmax, nrows = _line_launch(
        "line_tile_extinction", plan, d, tab, temps, tiles, rows)
    _check_stats("line_tile_extinction", stats, device)
    if out is None:
        if accumulate:
            raise ValueError("line_tile_extinction: accumulate needs out")
        subset = tiles is not None or rows is not None
        out = (torch.zeros if subset else torch.empty)(
            (nl, plan.n_coarse), dtype=torch.float32, device=device)
    elif (out.dtype != torch.float32 or out.device != device or
          tuple(out.shape) != (nl, plan.n_coarse) or
          not out.is_contiguous()):
        raise ValueError(f"line_tile_extinction: out must be a contiguous "
                         f"({nl}, {plan.n_coarse}) float32 tensor on "
                         f"{device}")
    if nrows == 0 or plan.n_coarse == 0 or ntiles == 0:
        return out

    with torch.cuda.device(device):
        lib = load_library()
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.line_tile_extinction(
            *(_ptr(args[k]) for k in ("wavn", "elow", "gf", "iso", "mask")),
            _ptr(args.get("tiles")), _ptr(args.get("rows")),
            *(_ptr(args[k]) for k in ("temps", "alphal", "alphad_f", "coef0",
                                     "densm", "kmax")),
            _ptr(out), _ptr(stats), nrows, ntiles, lmax, niso, plan.tw,
            plan.n_coarse, int(accumulate), int(bins_first),
            WFN_CODE[plan.wfn_tag], wn_i, dwn, ethresh, nwidth,
            -EXPCTE, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"line_tile_extinction failed to launch: CUDA "
                           f"error {err}")
    line_tile_extinction.launches += 1
    log.launched("line_tile_kernel")
    return out


@dataclasses.dataclass
class LineBand:
    """The tile classes of one :func:`line_tile_backward` launch (a band's
    near and stride-1 shell classes, or the unbanded plan):
    ``units`` [(plan, line tensors, global tiles (numpy) or None, their
    int32 tensor or None)], in launch order.  The class table the kernel
    takes is checked and packed at the first launch and kept in
    ``packed``; the layer rows are a launch's own argument, so a batched
    view of the plan launches the same band on its rows."""
    units: list
    packed: tuple | None = None


def _pack_classes(units):
    """Check a launch's tile classes once and pack them as the C entry
    takes them: (ptrs, ints (ctypes arrays), device, n_coarse, the
    contiguous tensors the pointers refer to)."""
    if not 0 < len(units) <= MAX_CLASSES:
        raise ValueError(f"line_tile_backward: {len(units)} tile classes; "
                         f"a launch takes 1 to {MAX_CLASSES}")
    n_coarse = units[0][0].n_coarse
    ptrs, ints, keep, device = [], [], [], None
    for plan, d, _, tiles in units:
        lines = {k: d[k] for k in ("wavn", "elow", "gf", "iso", "mask")}
        args = {**lines, **({} if tiles is None else {"tiles": tiles})}
        dev = _check_cuda("line_tile_backward", args, ints=("iso", "tiles"))
        if device not in (None, dev):
            raise ValueError("line_tile_backward: classes on two devices")
        device = dev
        ntiles, lmax = _check_lines("line_tile_backward", plan, d, tiles)
        if plan.n_coarse != n_coarse:
            raise ValueError("line_tile_backward: the classes' plans differ "
                             "in n_coarse")
        args = {k: v.contiguous() for k, v in args.items()}
        keep.append(args)
        ptrs += [args[k].data_ptr() for k in ("wavn", "elow", "gf", "iso",
                                              "mask")]
        ptrs.append(args["tiles"].data_ptr() if "tiles" in args else 0)
        ints += [ntiles, lmax, plan.tw, WFN_CODE[plan.wfn_tag]]
    return ((ctypes.c_longlong * len(ptrs))(*ptrs),
            (ctypes.c_int * len(ints))(*ints), device, n_coarse, keep)


def line_tile_backward(band: LineBand, tab, temps, g, wn_i: float,
                       dwn: float, ethresh: float, nwidth: float, *,
                       rows=None, bins_first: bool = False, acc=None):
    """Launch ``line_tile_backward`` (csrc/line_tile.cu) once for the
    backward of the :func:`line_tile_extinction` launches of ``band``
    (:class:`LineBand`), which share ``rows``, ``tab``, ``temps`` and
    ``bins_first``: ``g`` (nlayer, n_coarse) float32, the cotangent of the
    output, gives per layer the cotangents of ``temps`` and of the tables
    ``coef0``, ``densm``, ``alphal`` and ``alphad_f``, added in float64
    into ``acc`` (nlayer, 1 + 4 niso) (:func:`acc_grads` splits it; made
    here, zero, when None); returns ``acc``.  :func:`plain_line_tiles_vjp`,
    class by class, is its plain version.  The grid: a class's blocks (one
    per row of its line tensors) follow the previous class's, times the
    layer blocks.  Raises on any other device, type or shape, and when the
    launch fails."""
    from transit_tpu_torch.opacities._build import load_library

    if band.packed is None:
        band.packed = _pack_classes(band.units)
    ptrs, ints, device, n_coarse, _ = band.packed
    args = {**{k: tab[k] for k in ("alphal", "alphad_f", "coef0", "densm",
                                   "kmax")},
            "temps": temps, "g": g, **({} if rows is None else
                                       {"rows": rows})}
    if _check_cuda("line_tile_backward", args, ints=("rows",)) != device:
        raise ValueError(f"line_tile_backward: the tables are not on "
                         f"{device}, the classes' device")
    nl, niso, nrows = _check_tables("line_tile_backward", tab, temps, rows)
    if tuple(g.shape) != (nl, n_coarse):
        raise ValueError("line_tile_backward: g must be (nl, n_coarse)")
    if niso > 64:
        raise ValueError(f"line_tile_backward: {niso} > 64 isotopes")
    acc = _check_acc("line_tile_backward", acc, nl, niso, device)
    if nrows == 0 or n_coarse == 0:
        return acc
    args = {k: v.contiguous() for k, v in args.items()}
    with torch.cuda.device(device):
        lib = load_library()
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.line_tile_backward(
            ptrs, ints, len(band.units), _ptr(args.get("rows")),
            *(_ptr(args[k]) for k in ("temps", "alphal", "alphad_f", "coef0",
                                      "densm", "kmax", "g")),
            _ptr(acc), nrows, niso, n_coarse, int(bins_first), wn_i, dwn,
            ethresh, nwidth, -EXPCTE, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"line_tile_backward failed to launch: CUDA "
                           f"error {err}")
    line_tile_backward.launches += 1
    log.launched("line_tile_bwd_kernel")
    return acc


def _check_acc(fn: str, acc, nl: int, niso: int, device):
    """The backward kernels' float64 sums (nl, 1 + 4 niso): ``acc``
    checked, or a new zero one."""
    shape = (nl, 1 + 4 * niso)
    if acc is None:
        return torch.zeros(shape, dtype=torch.float64, device=device)
    if (acc.dtype != torch.float64 or tuple(acc.shape) != shape or
            acc.device != device or not acc.is_contiguous()):
        raise ValueError(f"{fn}: acc must be a contiguous {shape} float64 "
                         f"tensor on {device}")
    return acc


def acc_grads(acc, dtype) -> dict:
    """The backward kernels' float64 sums (nl, 1 + 4 niso) as the
    cotangents {"temps": (nl,), "coef0", "densm", "alphal", "alphad_f":
    (nl, niso)} in ``dtype``, cast once."""
    niso = (acc.shape[1] - 1) // 4
    a = acc.to(dtype)
    return {"temps": a[:, 0],
            **{k: a[:, 1 + i * niso:1 + (i + 1) * niso]
               for i, k in enumerate(("coef0", "densm", "alphal",
                                      "alphad_f"))}}


def _ptr(t):
    """A tensor's device pointer for ctypes (None: a null pointer)."""
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _check_stats(fn: str, stats, device):
    if stats is not None and (stats.dtype != torch.int64 or
                              tuple(stats.shape) != (3,) or
                              stats.device != device or
                              not stats.is_contiguous()):
        raise ValueError(f"{fn}: stats must be a (3,) int64 tensor on "
                         f"{device}")


# Kernel launches since the last reset (plain counts; set one to 0 to
# start a new count).
line_tile_extinction.launches = 0
line_tile_backward.launches = 0
layer_kmax.launches = 0
