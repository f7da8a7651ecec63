"""Line extinction on the unbanded tile plan through the CUDA line-tile
kernel — the counterpart of transit_tpu.opacities.pallas_lbl.

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
"""

from __future__ import annotations

import ctypes

import torch

from transit_tpu_torch.constants import SQRTLN2, SIGCTE, EXPCTE
from transit_tpu_torch.opacities.fast import FastPlan, _layer_widths
from transit_tpu_torch.opacities.voigt import (humlicek_regions,
                                               voigt_k_humlicek)

# Elements of the (layer, tile, bin, line) volume the plain version
# holds at once; it walks the tiles in chunks of this size.
PLAIN_ELEMENTS = 1 << 25
# Lines per chunk of the strength pre-pass (kmax scan).
KMAX_CHUNK = 1 << 16


def strength_coef(d, Z):
    """The strength coefficient SIGCTE*ratio/(mass*Z) per (layer, isotope),
    (nl, niso) (pallas_lbl.py:123-124)."""
    return (SIGCTE * d["iso_ratio"][None, :] /
            (d["iso_mass"][None, :] * Z.T)).contiguous()


def width_tables(d, temps, densities, mol_mass, mol_radius):
    """Per-(layer, isotope) Lorentz width ``alphal``, Doppler factor
    ``alphad_f`` (x wavenumber = alphaD) and absorber density ``densm``,
    each (nl, niso) (pallas_lbl.py:117-125)."""
    imol = d["iso_imol"].long()
    alphal, alphad_f = _layer_widths(temps, densities, d["iso_mass"], imol,
                                     mol_mass, mol_radius)
    return {"alphal": alphal.contiguous(), "alphad_f": alphad_f.contiguous(),
            "densm": densities.T[:, imol]}


def plain_kmax(d, temps, coef0):
    """Per-layer species-collapsed maximum line strength (nl,) over the
    full line list (pallas_lbl.py:127-133): the max over lines of
    k0 = gf e^(-c2 El/T) (1 - e^(-c2 nu/T)) coef0[layer, iso]; -inf for
    an empty list.  The plain PyTorch version of :func:`layer_kmax`."""
    T = temps[:, None]
    nlines = d["all_wavn"].shape[0]
    kmax = torch.full_like(temps, -torch.inf)
    for a in range(0, nlines, KMAX_CHUNK):
        w = d["all_wavn"][None, a:a + KMAX_CHUNK]
        s = (d["all_gf"][None, a:a + KMAX_CHUNK] *
             torch.exp(-EXPCTE * d["all_elow"][None, a:a + KMAX_CHUNK] / T) *
             (1.0 - torch.exp(-EXPCTE * w / T)))
        k = s * coef0[:, d["all_iso"][a:a + KMAX_CHUNK].long()]
        kmax = torch.maximum(kmax, k.amax(dim=1))
    return kmax


def layer_tables(d, temps, densities, Z, mol_mass, mol_radius):
    """The per-layer tables of the line-tile computation
    (pallas_lbl.py:111-133): :func:`width_tables`, ``coef0``
    (:func:`strength_coef`) and the per-layer ``kmax``
    (:func:`plain_kmax`)."""
    coef0 = strength_coef(d, Z)
    return {**width_tables(d, temps, densities, mol_mass, mol_radius),
            "coef0": coef0, "kmax": plain_kmax(d, temps, coef0)}


def _line_chunks(plan: FastPlan, d, tab, temps, ethresh: float,
                 nwidth: float):
    """Walk the tiles in chunks whose (layer, tile, bin, line) volume stays
    under PLAIN_ELEMENTS elements.  Yields (t0, t1, wn0, wv, keep, k, aD,
    aL, wing) for tiles t0:t1: the tiles' first-bin wavenumber
    wn_i + dwn*(tile*tw) is left to the caller; wv (tc, L) the line
    wavenumbers; and per (layer, tile, line), each (nl, tc, L): ``keep``,
    a line that is not masked or dropped by the ethresh cut; the line
    strength x density k, 0 where not kept; alphaD, alphaL, and the wing
    half-width nwidth * max(alphaD, alphaL)."""
    nl = temps.shape[0]
    ntiles, lmax = d["wavn"].shape
    T = temps[:, None, None]
    kthr = (ethresh * tab["kmax"])[:, None, None]
    step = max(1, PLAIN_ELEMENTS // max(1, nl * plan.tw * lmax))
    for t0 in range(0, ntiles, step):
        t1 = min(ntiles, t0 + step)
        wv = d["wavn"][t0:t1]                               # (tc, L)
        el = d["elow"][t0:t1]
        iso = d["iso"][t0:t1].long()
        aL = tab["alphal"][:, iso]                          # (nl, tc, L)
        k0 = (d["gf"][t0:t1] * torch.exp(-EXPCTE * el / T) *
              (1.0 - torch.exp(-EXPCTE * wv / T)) * tab["coef0"][:, iso])
        keep = d["mask"][t0:t1] & (k0 >= kthr)
        k = torch.where(keep, k0 * tab["densm"][:, iso], 0.0)
        aD = tab["alphad_f"][:, iso] * wv
        yield t0, t1, wv, keep, k, aD, aL, nwidth * torch.maximum(aD, aL)


def _tile_wn0(t0: int, t1: int, tw: int, wn_i: float, dwn: float, dtype,
              device):
    """The kernel's first-bin wavenumber of tiles t0:t1,
    wn_i + dwn*(tile*tw), rounded in ``dtype``."""
    tile = torch.arange(t0, t1, device=device).to(dtype)
    return wn_i + dwn * (tile * tw)


def _tile_chunks(plan: FastPlan, d, tab, temps, wn_i: float, dwn: float,
                 ethresh: float, nwidth: float):
    """Walk the tiles in chunks (:func:`_line_chunks`).  Yields (t0, t1,
    k, x, y, inv, use) for tiles t0:t1: the line strength x density k
    (nl, tc, L), 0 where the line is masked or dropped by the ethresh cut;
    the Voigt arguments x (nl, tc, tw, L) and y, and 1/alphaD inv, both
    (nl, tc, 1, L); and ``use`` (nl, tc, tw, L), a kept line inside its
    wing."""
    tw = plan.tw
    dtype, device = d["wavn"].dtype, d["wavn"].device
    bins = torch.arange(tw, device=device).to(dtype)
    for t0, t1, wv, keep, k, aD, aL, wing in _line_chunks(
            plan, d, tab, temps, ethresh, nwidth):
        inv = 1.0 / aD
        y = SQRTLN2 * aL * inv
        # The kernel's bin wavenumber, wn_i + dwn*(tile*tw) + dwn*bin:
        wn_col = (_tile_wn0(t0, t1, tw, wn_i, dwn, dtype, device)[:, None] +
                  (dwn * bins)[None, :])
        dist = (wn_col[:, :, None] - wv[:, None, :]).abs()  # (tc, tw, L)
        inv = inv[:, :, None, :]
        x = SQRTLN2 * dist[None] * inv                      # (nl, tc, tw, L)
        use = (dist[None] <= wing[:, :, None, :]) & keep[:, :, None, :]
        yield t0, t1, k, x, y[:, :, None, :], inv, use


def _find_runs(wn0, wv, wing, dwn: float, tw: int):
    """The run [b0, b1] of each line's bins inside its wing, the way the
    kernel finds it (csrc/line_tile.cu:find_run): seeded at the bin
    nearest the line, clamped to the tile; if that bin is out, walk toward
    the line until a bin is in, or the walk passes the line or the tile;
    then extend both ends while the next bin is in.  wn0 (tc,), wv
    (tc, L), wing (nl, tc, L) -> b0, b1 (int64) and ``found`` (bool),
    each (nl, tc, L)."""
    wn0 = wn0[None, :, None]
    wv = wv[None]

    def wn(b):
        return wn0 + dwn * b.to(wv.dtype)

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
             ethresh: float, nwidth: float):
    """The (layer, tile, line) entries of the kernel's design, by chunks
    of tiles: yields (t0, t1, b0, b1, reach, live), each (nl, tc, L) but
    t0, t1; ``reach`` is an unmasked line whose wing reaches a bin of the
    tile (the kernel computes its strength chain), ``live`` one of those
    that is kept, [b0, b1] the run of the tile's bins it reaches
    (:func:`_find_runs`).  The bins of the live runs are exactly ``use``
    of :func:`_tile_chunks`."""
    dtype, device = d["wavn"].dtype, d["wavn"].device
    for t0, t1, wv, keep, _, _, _, wing in _line_chunks(
            plan, d, tab, temps, ethresh, nwidth):
        wn0 = _tile_wn0(t0, t1, plan.tw, wn_i, dwn, dtype, device)
        b0, b1, found = _find_runs(wn0, wv, wing, dwn, plan.tw)
        reach = found & d["mask"][None, t0:t1]
        yield t0, t1, b0, b1, reach, keep & found


def run_counts(plan: FastPlan, d, tab, temps, wn_i: float, dwn: float,
               ethresh: float, nwidth: float) -> dict:
    """The kernel's own work on this data (:func:`bin_runs`):
    ``chains``, the (layer, tile, line) entries whose wing reaches the
    tile, each a strength chain; ``live``, the kept ones; ``pairs``, the
    (layer, bin, line) pairs of their runs, each a Voigt evaluation."""
    out = {"chains": 0, "live": 0, "pairs": 0}
    for *_, b0, b1, reach, live in bin_runs(plan, d, tab, temps, wn_i, dwn,
                                            ethresh, nwidth):
        out["chains"] += int(reach.sum())
        out["live"] += int(live.sum())
        out["pairs"] += int(torch.where(live, b1 - b0 + 1, 0).sum())
    return out


def plain_extinction(plan: FastPlan, d, temps, densities, Z, mol_mass,
                     mol_radius, wn_i: float, dwn: float, ethresh: float,
                     nwidth: float):
    """Extinction (nlayer, n_coarse): the plain PyTorch version of the
    line-tile kernel, on the tensors' device, walking the tiles in chunks
    (:func:`_tile_chunks`)."""
    tab = layer_tables(d, temps, densities, Z, mol_mass, mol_radius)
    nl = temps.shape[0]
    ntiles, tw = d["wavn"].shape[0], plan.tw
    out = torch.zeros((nl, ntiles * tw), dtype=d["wavn"].dtype,
                      device=d["wavn"].device)
    for t0, t1, k, x, y, inv, use in _tile_chunks(
            plan, d, tab, temps, wn_i, dwn, ethresh, nwidth):
        prof = voigt_k_humlicek(x, y) * inv
        val = (torch.where(use, prof, 0.0) * k[:, :, None, :]).sum(dim=3)
        out[:, t0 * tw:t1 * tw] = val.reshape(nl, (t1 - t0) * tw)
    return out[:, :plan.n_coarse]


def work_counts(plan: FastPlan, d, tab, temps, wn_i: float, dwn: float,
                ethresh: float, nwidth: float) -> dict:
    """The work the line-tile function needs on this data, whatever the
    design: ``layer_lines``, one strength and width chain per (layer,
    line) of the line list; and the Voigt evaluations of kept lines inside
    their wing, one per (layer, bin, line), by Humlicek region (``II``,
    ``III``, ``IV``)."""
    out = {"layer_lines": temps.shape[0] * d["all_wavn"].shape[0],
           "II": 0, "III": 0, "IV": 0}
    for *_, x, y, _, use in _tile_chunks(plan, d, tab, temps, wn_i, dwn,
                                         ethresh, nwidth):
        for name, region in zip(("II", "III", "IV"),
                                humlicek_regions(x, y)):
            out[name] += int((use & region).sum())
    return out


def kernel_extinction(plan: FastPlan, d, temps, densities, Z, mol_mass,
                      mol_radius, wn_i: float, dwn: float, ethresh: float,
                      nwidth: float):
    """Extinction (nlayer, n_coarse) through the CUDA kernels.

    Same arguments as pallas_extinction: the plan, its device arrays
    (fast.fast_device_arrays), layer temperatures (cgs), densities
    (nmol, nl), partition functions Z (niso, nl) and the molecules'
    masses and radii.  A CPU tensor takes :func:`plain_extinction`; a
    CUDA tensor launches :func:`layer_kmax` and then the line-tile
    kernel, which take float32 only.
    """
    if d["wavn"].device.type == "cpu":
        return plain_extinction(plan, d, temps, densities, Z, mol_mass,
                                mol_radius, wn_i, dwn, ethresh, nwidth)
    # The kmax scan first: the card runs it while the host builds the
    # other tables.
    coef0 = strength_coef(d, Z)
    kmax = layer_kmax(d, temps, coef0)
    tab = {**width_tables(d, temps, densities, mol_mass, mol_radius),
           "coef0": coef0, "kmax": kmax}
    return line_tile_extinction(plan, d, tab, temps, wn_i, dwn, ethresh,
                                nwidth)


def _check_cuda(fn: str, args: dict, ints=("iso",)):
    """Raise unless every tensor of ``args`` is on one CUDA device,
    float32 (int32 for ``ints``, bool for ``mask``); returns the
    device."""
    device = next(iter(args.values())).device
    if device.type != "cuda":
        raise ValueError(f"{fn} runs on CUDA tensors, not {device}")
    for name, t in args.items():
        want = (torch.int32 if name in ints else
                torch.bool if name == "mask" else torch.float32)
        if t.dtype != want:
            raise TypeError(f"{fn}: {name} is {t.dtype}, the kernel takes "
                            f"{want}")
        if t.device != device:
            raise ValueError(f"{fn}: {name} is on {t.device}, not "
                             f"{device}")
    return device


def layer_kmax(d, temps, coef0):
    """Launch ``layer_kmax`` (csrc/line_tile.cu): the per-layer maximum
    line strength (nl,) float32 over the full line list of ``d``, at the
    layer temperatures ``temps`` (nl,) and strength coefficients
    ``coef0`` (nl, niso) — :func:`plain_kmax` on the card.  Raises on any
    other device, type or shape, and when the launch fails."""
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
    kmax = torch.full((nl,), -torch.inf, dtype=torch.float32,
                      device=device)
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
    return kmax


def line_tile_extinction(plan: FastPlan, d, tab, temps, wn_i: float,
                         dwn: float, ethresh: float, nwidth: float,
                         stats=None):
    """Launch ``line_tile_extinction`` (csrc/line_tile.cu) on the line
    tiles ``d`` and the per-layer tables ``tab`` (:func:`layer_tables`)
    -> extinction (nlayer, n_coarse), float32 on the tiles' CUDA device.
    ``stats``, a (3,) int64 tensor on the card, gets the strength chains
    computed, the live (layer, tile, line) entries and the (layer, bin,
    line) pairs evaluated added to it (:func:`run_counts` counts the
    same on the host).  Raises on any other device, type or shape, and
    when the launch fails."""
    from transit_tpu_torch.opacities._build import load_library

    if plan.class_tiles is not None:
        raise NotImplementedError(
            "tile classes come with the banded-plan slice")
    lines = {k: d[k] for k in ("wavn", "elow", "gf", "iso", "mask")}
    args = {**lines, **tab, "temps": temps}
    device = _check_cuda("line_tile_extinction", args)
    ntiles, lmax = d["wavn"].shape
    if plan.ntiles != ntiles or plan.lmax != lmax:
        raise ValueError("line tensors do not match the plan")
    for name in lines:
        if tuple(d[name].shape) != (ntiles, lmax):
            raise ValueError(f"line_tile_extinction: {name} has shape "
                             f"{tuple(d[name].shape)}")
    nl = temps.shape[0]
    niso = tab["alphal"].shape[1]
    for name in ("alphal", "alphad_f", "coef0", "densm"):
        if tuple(tab[name].shape) != (nl, niso):
            raise ValueError(f"line_tile_extinction: {name} has shape "
                             f"{tuple(tab[name].shape)}")
    if tuple(tab["kmax"].shape) != (nl,):
        raise ValueError("line_tile_extinction: kmax must be (nl,)")
    if stats is not None and (stats.dtype != torch.int64 or
                              tuple(stats.shape) != (3,) or
                              stats.device != device or
                              not stats.is_contiguous()):
        raise ValueError(f"line_tile_extinction: stats must be a (3,) "
                         f"int64 tensor on {device}")
    out = torch.empty((nl, plan.n_coarse), dtype=torch.float32,
                      device=device)
    if nl == 0 or plan.n_coarse == 0:
        return out
    args = {k: v.contiguous() for k, v in args.items()}

    def ptr(t):
        return ctypes.c_void_p(None if t is None else t.data_ptr())

    with torch.cuda.device(device):
        lib = load_library()
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.line_tile_extinction(
            *(ptr(args[k]) for k in ("wavn", "elow", "gf", "iso", "mask")),
            *(ptr(args[k]) for k in ("temps", "alphal", "alphad_f", "coef0",
                                     "densm", "kmax")),
            ptr(out), ptr(stats), nl, ntiles, lmax, niso, plan.tw,
            plan.n_coarse, wn_i, dwn, ethresh, nwidth, -EXPCTE,
            ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"line_tile_extinction failed to launch: CUDA "
                           f"error {err}")
    line_tile_extinction.launches += 1
    return out


# Kernel launches since the last reset (plain counts; set one to 0 to
# start a new count).
line_tile_extinction.launches = 0
layer_kmax.launches = 0
