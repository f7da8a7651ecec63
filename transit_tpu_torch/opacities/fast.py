"""Host-side line-tile plan of the fast extinction path.

The counterpart of the planner half of transit_tpu.opacities.fast
(fast.py:43-285, 881-1200, 1248-1267): the coarse wavenumber axis is
split into tiles of TW bins and the wavenumber-sorted line list is
bucketed to every tile its wings can reach (contiguous slices,
duplication factor ~(2*halo+TW)/TW).  :func:`make_banded_plans` splits
the layers into width bands with one plan each, and splits a band's
lines into a near window and far-wing distance shells.  The plans are
numpy and equal transit_tpu's field for field; :func:`fast_device_arrays`
and :func:`banded_device_arrays` turn them into the padded
(ntiles, lmax) line tensors that the kernels read
(opacities/kernel_lbl.py, opacities/kernel_shell.py, opacities/banded.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from transit_tpu_torch.constants import SQRTLN2, KB, AMU, LS, PI

# Far-line margin: region II of the Humlicek w4 kernel is selected when
# s = |x| + y >= 5.5, i.e. at distances >= 5.5/sqrt(ln2) Doppler widths
# from the line center; 1.02 is a safety factor on the host width bound
# (transit_tpu/opacities/fast.py:43-49).
R2_MARGIN = 1.02 * 5.5 / float(SQRTLN2)
# Far-wing decimation: a line at distance >= FAR_FACTOR * s bins from
# every evaluation point may be evaluated on a stride-s grid and
# Catmull-Rom interpolated back up (per-line relative error ~3e-5;
# fast.py:51-61).
FAR_FACTOR = 24
# Scaled distance beyond which the two-term asymptotic Faddeeva kernel
# replaces the region-II rational in a shell (fast.py:63-68).
X_ASYM = 15.0
# Relative per-element kernel costs of the planner's absorption decision
# (fast.py:70-78).
W4_COST = 1.0
R2_COST = 0.3


@dataclasses.dataclass
class FastPlan:
    """Host-side tile bucketing of the (wavenumber-sorted) line list."""
    wavn: np.ndarray        # (nl,) sorted ascending
    isoid: np.ndarray       # (nl,)
    elow: np.ndarray
    gf: np.ndarray
    tile_start: np.ndarray  # (ntiles,) first line index per tile
    tile_count: np.ndarray  # (ntiles,) lines per tile (BOTH ranges)
    lmax: int               # max lines per tile (padded length)
    tw: int                 # tile width in coarse bins
    ntiles: int
    n_coarse: int
    halo_bins: float        # wing reach used for bucketing, in bins
    # Optional tile classes: tiles grouped by line count so sparse tiles
    # don't pay the densest tile's lmax padding.  class_tiles[c] holds the
    # global tile indices of class c, padded to length class_lmax[c]:
    class_tiles: list = None
    class_lmax: list = None
    # Register layout of the tile kernel: "lines" puts the line axis on
    # the 128-lane vector dimension (dense tiles — lmax rounds to 128);
    # "bins" puts the BIN axis on lanes and lines on the 8-wide sublane
    # axis (lmax rounds to 8) — chosen for sparse far shells, whose
    # ~20-40 lines/tile would otherwise pad 3-8x to fill the lanes:
    lanes: str = "lines"
    # Voigt kernel this plan's lines are valid for: "w4" (full Humlicek),
    # "r2" (region-II rational — far shells), or "asym2" (two-term
    # asymptotic — outer shells with x >= X_ASYM everywhere):
    wfn_tag: str = "w4"
    # Decimated-shell line weighting (see _block_lines): band width
    # bounds (aL_max, aDf_max) from which the kernel reconstructs each
    # tile's halo; None = per-layer hard wing cutoff (near/s1 shells):
    line_weight: tuple = None
    # Optional SECOND per-tile line range (far shells bucket the ranges
    # left AND right of the tile's near window into ONE padded tensor —
    # two ~40-line sides each padding to the 128-lane granule would
    # otherwise double the dominant padding floor; see make_banded_plans).
    # tile_count stays the combined count (consumers: tile classes, the
    # sharded path's LPT block costs); tile_count1 is range 1's length:
    tile_start2: np.ndarray = None   # (ntiles,) or None
    tile_count1: np.ndarray = None   # (ntiles,) or None



def make_fast_plan(wavn, isoid, elow, gf, wn_i: float, dwn: float,
                   n_coarse: int, max_width: float, nwidth: float,
                   tw: int = None, aL_max: float = None,
                   aDf_max: float = None, classes: bool = False) -> FastPlan:
    """Bucket lines by coarse tile.

    max_width: upper bound on max(alphaD, alphaL) over all layers/isotopes
    (host-computed from the atmosphere); wings reach nwidth*max_width.
    tw: tile width in coarse bins; by default sized near the halo width —
    each line is evaluated over its whole tile, so wasted work scales with
    tw/halo while line duplication scales with halo/tw.

    aL_max/aDf_max: when given, the halo is sized *per tile* as
    nwidth*max(aL_max, aDf_max*wn_tile)/dwn — the Doppler width grows
    linearly with wavenumber, so a wide spectral range (e.g. 1-20 um) gets
    tight halos at its red end instead of the global worst case.
    """
    if tw is None:
        # Tile height: each line in a tile is evaluated over all tw bins,
        # so wasted work ~ (tw + 2*halo)/(2*halo); memory duplication of
        # line data ~ (tw + 2*halo)/tw.  tw ~ halo balances both; the line
        # axis (not tw) is the 128-lane axis, so small tw is fine:
        halo_est = nwidth * max_width / dwn
        tw = int(min(256, max(8, -(-int(halo_est) // 8) * 8)))
    order = np.argsort(wavn, kind="stable")
    wavn = np.asarray(wavn, dtype=np.float64)[order]
    isoid = np.asarray(isoid, dtype=np.int32)[order]
    elow = np.asarray(elow, dtype=np.float64)[order]
    gf = np.asarray(gf, dtype=np.float64)[order]

    ntiles = -(-n_coarse // tw)
    if aL_max is not None and aDf_max is not None:
        wn_hi_tile = wn_i + (np.arange(ntiles) + 1) * tw * dwn
        width_t = np.maximum(aL_max, aDf_max * wn_hi_tile)
        halo = nwidth * width_t / dwn + 1.0            # (ntiles,)
        halo_rep = float(halo.max())
    else:
        halo = nwidth * max_width / dwn + 1.0          # scalar
        halo_rep = float(halo)
    lo = wn_i + (np.arange(ntiles) * tw - halo) * dwn
    hi = wn_i + ((np.arange(ntiles) + 1) * tw + halo) * dwn
    start = np.searchsorted(wavn, lo, side="left")
    end = np.searchsorted(wavn, hi, side="right")
    return _subplan(wavn, isoid, elow, gf, start, end, tw=tw,
                    ntiles=ntiles, n_coarse=n_coarse, halo_rep=halo_rep,
                    classes=classes)


def _tile_classes(count, lmax: int, classes: bool, min_level: int = 128):
    """Group tiles by line count in powers-of-two multiples of
    ``min_level`` (the layout's line-axis register granule); a class is
    only worth a separate kernel if it has enough tiles."""
    ntiles = count.shape[0]
    if not (classes and ntiles > 1 and lmax > min_level):
        return None, None
    cls_of = np.maximum(min_level, 2 ** np.ceil(
        np.log2(np.maximum(count, 1))).astype(np.int64))
    cls_of = np.minimum(cls_of, lmax)
    # Merge classes with <8 tiles into the next-larger level (a tiny
    # class isn't worth its own compiled kernel):
    levels = sorted(set(cls_of.tolist()))
    for i, lv in enumerate(levels[:-1]):
        if (cls_of == lv).sum() < 8:
            cls_of[cls_of == lv] = levels[i + 1]
    class_tiles, class_lmax = [], []
    for lv in sorted(set(cls_of.tolist())):
        idx = np.nonzero(cls_of == lv)[0]
        class_tiles.append(idx.astype(np.int32))
        class_lmax.append(int(lv))
    if len(class_tiles) == 1:
        return None, None
    return class_tiles, class_lmax


def _subplan(wavn, isoid, elow, gf, start, end, tw, ntiles, n_coarse,
             halo_rep, classes, lanes: str = "lines",
             wfn_tag: str = "w4", line_weight: tuple = None,
             start2=None, end2=None):
    """FastPlan over pre-sorted line arrays with explicit per-tile line
    ranges [start, end) (+ an optional second range [start2, end2) —
    the two sides of a far shell share one padded tensor)."""
    count1 = end - start
    count = count1 if start2 is None else count1 + (end2 - start2)
    lmax = int(count.max()) if count.size else 0
    lmax = max(lmax, 1)
    # Round up to the line axis' register granule (lanes or sublanes):
    granule = 128 if lanes == "lines" else 8
    lmax = -(-lmax // granule) * granule
    class_tiles, class_lmax = _tile_classes(count, lmax, classes,
                                            min_level=granule)
    return FastPlan(wavn=wavn, isoid=isoid, elow=elow, gf=gf,
                    tile_start=start.astype(np.int32),
                    tile_count=count.astype(np.int32),
                    lmax=lmax, tw=tw, ntiles=ntiles, n_coarse=n_coarse,
                    halo_bins=halo_rep, class_tiles=class_tiles,
                    class_lmax=class_lmax, lanes=lanes, wfn_tag=wfn_tag,
                    line_weight=line_weight,
                    tile_start2=(None if start2 is None
                                 else start2.astype(np.int32)),
                    tile_count1=(None if start2 is None
                                 else count1.astype(np.int32)))


def _tile_tensors(plan: FastPlan, tiles, lmax, dtype, device):
    """Padded (len(tiles), lmax) line tensors for the given tile set."""
    nl = plan.wavn.shape[0]
    j = np.arange(lmax)[None, :]
    if plan.tile_start2 is None:
        idx = plan.tile_start[tiles][:, None] + j
    else:
        c1 = plan.tile_count1[tiles][:, None]
        idx = np.where(j < c1, plan.tile_start[tiles][:, None] + j,
                       plan.tile_start2[tiles][:, None] + (j - c1))
    mask = j < plan.tile_count[tiles][:, None]
    idx = np.clip(idx, 0, max(nl - 1, 0))

    def t(a, dt=dtype):
        return torch.as_tensor(a, dtype=dt, device=device)
    return {
        "wavn": t(plan.wavn[idx]),
        "elow": t(plan.elow[idx]),
        "gf": t(plan.gf[idx]),
        "iso": t(plan.isoid[idx], torch.int32),
        "mask": t(mask, torch.bool),
    }


def fast_device_arrays(plan: FastPlan, iso, dtype=torch.float32,
                       device="cuda"):
    """Per-tile padded line tensors on ``device``."""
    if plan.class_tiles is not None:
        cls = [_tile_tensors(plan, t, lm, dtype, device)
               for t, lm in zip(plan.class_tiles, plan.class_lmax)]
        base = {"classes": cls}
    else:
        base = _tile_tensors(plan, np.arange(plan.ntiles), plan.lmax, dtype,
                             device)

    def t(a, dt=dtype):
        return torch.as_tensor(a, dtype=dt, device=device)
    return {
        **base,
        "iso_mass": t(iso.mass),
        "iso_ratio": t(iso.ratio),
        "iso_imol": t(iso.imol, torch.int32),
        # full (unbucketed) line arrays for the kmax pass:
        "all_wavn": t(plan.wavn),
        "all_elow": t(plan.elow),
        "all_gf": t(plan.gf),
        "all_iso": t(plan.isoid, torch.int32),
    }


@dataclasses.dataclass
class BandedPlan:
    """Layer-banded fast plans (transit_tpu/opacities/fast.py:881-907).

    Layers are permuted by descending width bound and split into
    contiguous bands; each band gets its own FastPlan whose halo is that
    band's width bound.  Results equal the unbanded path's (the wing mask
    uses the true per-layer widths; banding only skips pairs the mask
    would zero).
    """
    perm: np.ndarray          # (nl,) layer order, widest first
    inv_perm: np.ndarray      # (nl,) inverse permutation
    slices: list              # [(lo, hi)] into perm per band
    plans: list               # FastPlan per band (near plan when split)
    # Far-line split: per band, a list of distance SHELLS
    # [(far plan, None, stride), ...] over the wing-only line ranges
    # left and right of each tile's near window (one two-range plan per
    # shell); None when the band isn't split.
    far_plans: list = None


def layer_width_bounds(atm, mol, iso_mass, iso_imol=None):
    """Per-layer width bounds from the init atmosphere: (aL_max, aDf_max),
    each (nlayer,); alphaD = aDf * wn (width formulas of
    extinction.c:364-395)."""
    t = atm.temp * atm.tfct
    fdop = np.sqrt(2.0 * KB * t / AMU) * SQRTLN2 / LS
    flor = np.sqrt(2.0 * KB * t / PI / AMU) / (AMU * LS)
    if iso_imol is None:
        iso_imol = np.zeros(iso_mass.shape[0], dtype=int)
    aL = np.zeros(t.shape[0])
    aDf = np.zeros(t.shape[0])
    for mi in range(iso_mass.shape[0]):
        aDf = np.maximum(aDf, fdop / np.sqrt(iso_mass[mi]))
        al = np.zeros_like(t)
        for j in range(len(mol.mass)):
            csd = mol.radius[j] + mol.radius[iso_imol[mi]]
            al += (atm.d[j] / mol.mass[j] * csd * csd *
                   np.sqrt(1.0 / iso_mass[mi] + 1.0 / mol.mass[j]))
        aL = np.maximum(aL, flor * al)
    return aL, aDf


def _lanes_choice(cnt, ne: int, far_decimate: bool) -> str:
    """Register layout of a far-shell plan (fast.py:1063-1074 and
    1125-1131, one rule): "bins" when it pads less than "lines"."""
    mean_c = float(cnt.sum()) / max(len(cnt), 1)
    waste_lines = max(128.0, mean_c) / max(mean_c, 1.0)
    lane_pad = 128.0 * (-(-ne // 128)) / max(ne, 1)
    waste_bins = lane_pad * max(8.0, mean_c) / max(mean_c, 1.0)
    return "bins" if far_decimate and waste_bins < waste_lines else "lines"


def make_banded_plans(wavn, isoid, elow, gf, wn_i: float, dwn: float,
                      n_coarse: int, aL_layers, aDf_layers, wn_max: float,
                      nwidth: float, max_bands: int = 4,
                      ratio: float = 3.0, tw_scale: float = None,
                      classes: bool = True,
                      split_far: bool = True,
                      far_decimate: bool = True,
                      max_stride: int = 64) -> BandedPlan:
    """Split layers into width bands and build one FastPlan per band
    (transit_tpu/opacities/fast.py:932-1173, the same plans field for
    field).

    aL_layers/aDf_layers: per-layer width bounds (layer_width_bounds).
    A new band starts when the layer width falls below 1/ratio of the
    current band's maximum, up to max_bands bands.  The tile width is
    the band's halo (a quarter of it once distance shells carry the
    wings and the region-II margin is >= 8 bins), a power of two in
    [8, 512].

    split_far: per tile, split the bucketed lines into a near window
    (within R2_MARGIN Doppler widths of a tile bin, full Humlicek w4) and
    far ranges (wing only, region-II rational).  far_decimate: split the
    far ranges into distance shells, stride s covering
    [FAR_FACTOR*s, FAR_FACTOR*2s) bins, each evaluated on an s-decimated
    grid and Catmull-Rom upsampled; the stride-1 shell may be absorbed
    into the near window when the padded-eval cost model says so.
    """
    w = np.maximum(aL_layers, aDf_layers * wn_max)
    perm = np.argsort(-w, kind="stable")
    ws = w[perm]
    slices = []
    lo = 0
    for i in range(1, len(ws) + 1):
        if i == len(ws) or (ws[i] < ws[lo] / ratio and
                            len(slices) < max_bands - 1):
            slices.append((lo, i))
            lo = i
    order = np.argsort(wavn, kind="stable")
    wavn_s = np.asarray(wavn, dtype=np.float64)[order]
    isoid_s = np.asarray(isoid, dtype=np.int32)[order]
    elow_s = np.asarray(elow, dtype=np.float64)[order]
    gf_s = np.asarray(gf, dtype=np.float64)[order]
    plans = []
    far_plans = [] if split_far else None
    for (a, b) in slices:
        sel = perm[a:b]
        halo_est = nwidth * float(w[sel].max()) / dwn
        margin_est = (R2_MARGIN * float(aDf_layers[sel].max()) *
                      wn_max / dwn)
        scale = (tw_scale if tw_scale
                 else (0.25 if (halo_est >= 2.0 * FAR_FACTOR + 16.0
                                and margin_est >= 8.0)
                       else 1.0))
        tw = int(min(512, max(8, 2 ** int(np.ceil(np.log2(
            max(halo_est * scale, 1.0)))))))
        aL_max = float(aL_layers[sel].max())
        aDf_max = float(aDf_layers[sel].max())
        ntiles = -(-n_coarse // tw)
        k = np.arange(ntiles)
        wn_hi_tile = wn_i + (k + 1) * tw * dwn
        width_t = np.maximum(aL_max, aDf_max * wn_hi_tile)
        halo = nwidth * width_t / dwn + 1.0          # (ntiles,) in bins
        lo_full = wn_i + (k * tw - halo) * dwn
        hi_full = wn_i + ((k + 1) * tw + halo) * dwn
        margin = R2_MARGIN * aDf_max * (wn_hi_tile + halo * dwn) + dwn
        do_split = split_far and bool(np.any(halo * dwn > 2.0 * margin))
        if not do_split:
            plans.append(_subplan(
                wavn_s, isoid_s, elow_s, gf_s,
                np.searchsorted(wavn_s, lo_full, side="left"),
                np.searchsorted(wavn_s, hi_full, side="right"),
                tw=tw, ntiles=ntiles, n_coarse=n_coarse,
                halo_rep=float(halo.max()), classes=classes))
            if split_far:
                far_plans.append(None)
            continue
        halo_wn = halo * dwn                              # (ntiles,)
        tile_lo = wn_i + k * tw * dwn
        tile_hi = wn_i + (k + 1) * tw * dwn

        # Shell stride s spans [bound(s), bound(2s)) in wn per tile; the
        # stride-1 shell starts at the region-II margin, the outermost
        # ends at the full wing bound:
        def bound(s):
            if s == 1:
                return margin
            return np.minimum(np.maximum(margin + s * dwn,
                                         FAR_FACTOR * s * dwn), halo_wn)

        strides = [1]
        if far_decimate:
            s = 2
            smax = min(max_stride, tw // 4)
            while s <= smax and bool(np.any(bound(s) < halo_wn)):
                strides.append(s)
                s *= 2

        def side_ranges(lo_b, hi_b):
            """Per-tile line ranges of one shell's left and right side."""
            sL0 = np.searchsorted(wavn_s, tile_lo - hi_b, side="left")
            sL1 = np.searchsorted(wavn_s, tile_lo - lo_b, side="left")
            sR0 = np.searchsorted(wavn_s, tile_hi + lo_b, side="right")
            sR1 = np.searchsorted(wavn_s, tile_hi + hi_b, side="right")
            return sL0, sL1, sR0, sR1

        def est_cost(cnt, ne, weight, lanes):
            """Padded-eval cost of a plan with per-tile line counts
            ``cnt`` over ``ne`` evaluation bins in layout ``lanes``;
            ``weight`` is the kernel's relative per-element cost."""
            if lanes == "bins":
                pl = np.maximum(8, -(-cnt // 8) * 8)
                return weight * float(pl.sum()) * 128 * (-(-ne // 128))
            pl = np.maximum(128, -(-cnt // 128) * 128)
            return weight * float(pl.sum()) * ne

        # Absorb the stride-1 shell into the near window when one merged
        # w4 plan costs less than near + stride-1 shell (the w4 kernel
        # equals the region-II rational on region-II inputs):
        near_b = margin
        absorb = False
        if len(strides) > 1:
            b2 = np.minimum(bound(strides[1]), halo_wn)
            aL0, aL1, aR0, aR1 = side_ranges(margin, b2)
            cnt_s1 = (aL1 - aL0) + (aR1 - aR0)
            n0 = np.searchsorted(wavn_s, tile_lo - margin, side="left")
            n1 = np.searchsorted(wavn_s, tile_hi + margin, side="right")
            merged = est_cost((n1 - n0) + cnt_s1, tw, W4_COST, "lines")
            sep = (est_cost(n1 - n0, tw, W4_COST, "lines") +
                   est_cost(cnt_s1, tw, R2_COST,
                            _lanes_choice(cnt_s1, tw, far_decimate)))
            absorb = bool(merged < sep)
            if absorb:
                near_b = b2
        plans.append(_subplan(
            wavn_s, isoid_s, elow_s, gf_s,
            np.searchsorted(wavn_s, tile_lo - near_b, side="left"),
            np.searchsorted(wavn_s, tile_hi + near_b, side="right"),
            tw=tw, ntiles=ntiles, n_coarse=n_coarse,
            halo_rep=float(halo.max()), classes=classes))

        def mk_far(sL0, sL1, sR0, sR1, ne, lo_b, stride_s):
            """Far-shell subplan: both sides of the tile's near window in
            one two-range padded tensor; the asymptotic kernel where every
            line sits at x >= X_ASYM from every evaluation point; the
            smooth per-line halo weight on decimated shells."""
            cnt = (sL1 - sL0) + (sR1 - sR0)
            lanes = _lanes_choice(cnt, ne, far_decimate)
            aD_hi = aDf_max * (wn_hi_tile + halo_wn)
            x_min = float(np.min(float(SQRTLN2) *
                                 (lo_b - stride_s * dwn) / aD_hi))
            tag = ("asym2" if far_decimate and x_min >= X_ASYM
                   else "r2")
            lwt = ((aL_max, aDf_max) if stride_s > 1 else None)
            return _subplan(wavn_s, isoid_s, elow_s, gf_s, sL0, sL1,
                            tw=tw, ntiles=ntiles, n_coarse=n_coarse,
                            halo_rep=float(halo.max()), classes=classes,
                            lanes=lanes, wfn_tag=tag, line_weight=lwt,
                            start2=sR0, end2=sR1)

        shells = []
        for si, s in enumerate(strides):
            if s == 1 and absorb:
                continue                 # folded into the near window
            lo_b = bound(s) if s > 1 else near_b
            # The outermost decimated shell extends to 1.125*halo, where
            # its per-line halo weight reaches 0:
            if si + 1 < len(strides):
                hi_b = bound(strides[si + 1])
            else:
                hi_b = halo_wn if s == 1 else 1.125 * halo_wn
            ne = tw // s + 3 if s > 1 else tw
            sL0, sL1, sR0, sR1 = side_ranges(lo_b, hi_b)
            if int((sL1 - sL0).max()) > 0 or int((sR1 - sR0).max()) > 0:
                shells.append((mk_far(sL0, sL1, sR0, sR1, ne, lo_b, s),
                               None, s))
        far_plans.append(shells if shells else None)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    return BandedPlan(perm=perm, inv_perm=inv, slices=slices, plans=plans,
                      far_plans=far_plans)


def _far_tile_tensors(fp: FastPlan, iso, dtype, device):
    """Tile-tensor subset of fast_device_arrays for a far subplan (the
    all_*/iso_* arrays are shared with the band's near dict)."""
    fd = fast_device_arrays(fp, iso, dtype=dtype, device=device)
    return {k: fd[k] for k in
            (("classes",) if fp.class_tiles is not None
             else ("wavn", "elow", "gf", "iso", "mask"))}


def banded_device_arrays(bplan: BandedPlan, iso, dtype=torch.float32,
                         device="cuda"):
    """Per-band tensors on ``device`` (a list parallel to bplan.plans, as
    transit_tpu's banded_device_arrays).  A far-split band's dict gains a
    "far" list parallel to its shells: (tensors, None) per shell.  The
    bands' full line arrays (``all_*``) and isotope tables are equal, so
    every band shares the first band's tensors."""
    devs = []
    for i, p in enumerate(bplan.plans):
        d = fast_device_arrays(p, iso, dtype=dtype, device=device)
        if devs:
            d.update({k: v for k, v in devs[0].items()
                      if k.startswith(("all_", "iso_"))})
        far = bplan.far_plans[i] if bplan.far_plans is not None else None
        if far:
            d["far"] = [tuple(_far_tile_tensors(fp, iso, dtype, device)
                              if fp is not None else None
                              for fp in (pL, pR))
                        for (pL, pR, _s) in far]
        devs.append(d)
    return devs


def _layer_widths(temps, densities, iso_mass, iso_imol, mol_mass,
                  mol_radius):
    """Lorentz width and Doppler width factor per (layer, isotope)
    (extinction.c:364-395): temps (nl,), densities (nmol, nl) ->
    alphal, alphad_f, each (nl, niso).  The Doppler width is
    alphad_f * wavenumber."""
    fdoppler = torch.sqrt(2.0 * KB * temps / AMU) * SQRTLN2 / LS   # (nl,)
    florentz = torch.sqrt(2.0 * KB * temps / PI / AMU) / (AMU * LS)
    csdiam = mol_radius[None, :] + mol_radius[iso_imol][:, None]   # (ni, nm)
    term = (densities.T[:, None, :] / mol_mass[None, None, :] *
            csdiam * csdiam *
            torch.sqrt(1.0 / iso_mass[:, None] + 1.0 / mol_mass[None, :]))
    alphal = florentz[:, None] * term.sum(dim=2)
    alphad_f = fdoppler[:, None] / torch.sqrt(iso_mass)[None, :]
    return alphal, alphad_f


def max_width_bound(atm, mol, iso_mass, wn_max: float,
                    iso_imol=None) -> float:
    """Host-side max of max(alphaD, alphaL) over layers/isotopes (the exact
    width formulas of extinction.c:364-395) for tile-halo sizing."""
    t = atm.temp * atm.tfct
    fdop = np.sqrt(2.0 * KB * t / AMU) * SQRTLN2 / LS
    flor = np.sqrt(2.0 * KB * t / PI / AMU) / (AMU * LS)
    amax = 0.0
    if iso_imol is None:
        iso_imol = np.zeros(iso_mass.shape[0], dtype=int)
    for mi in range(iso_mass.shape[0]):
        ad = fdop / np.sqrt(iso_mass[mi]) * wn_max
        amax = max(amax, ad.max())
        al = np.zeros_like(t)
        for j in range(len(mol.mass)):
            csd = mol.radius[j] + mol.radius[iso_imol[mi]]
            al += (atm.d[j] / mol.mass[j] * csd * csd *
                   np.sqrt(1.0 / iso_mass[mi] + 1.0 / mol.mass[j]))
        amax = max(amax, (flor * al).max())
    return float(amax)
