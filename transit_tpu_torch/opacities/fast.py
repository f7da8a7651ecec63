"""Host-side line-tile plan of the fast extinction path.

The counterpart of the planner half of transit_tpu.opacities.fast
(fast.py:82-285, 1248-1267): the coarse wavenumber axis is split into
tiles of TW bins and the wavenumber-sorted line list is bucketed to every
tile its wings can reach (contiguous slices, duplication factor
~(2*halo+TW)/TW).  The plan is numpy and equals transit_tpu's field for
field; :func:`fast_device_arrays` turns it into the padded
(ntiles, lmax) line tensors that the line-tile kernel
(opacities/kernel_lbl.py) reads.

The tile executor of the banded main path (``_run_tiles``, the far-wing
shells) comes with the banded-plan slice.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from transit_tpu_torch.constants import SQRTLN2, KB, AMU, LS, PI


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
