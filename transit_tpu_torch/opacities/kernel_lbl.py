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

The per-layer tables (widths, strength coefficient, density, the
species-collapsed kmax) are torch ops here, as JAX computes them outside
``pallas_call``.  On a CUDA tensor the wrapper launches
``line_tile_extinction`` (csrc/line_tile.cu) or raises; on a CPU tensor
it computes :func:`plain_extinction`, the plain PyTorch version of the
same function.
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


def layer_tables(d, temps, densities, Z, mol_mass, mol_radius):
    """Per-(layer, isotope) tables of the line-tile computation
    (pallas_lbl.py:111-133): Lorentz width ``alphal``, Doppler factor
    ``alphad_f`` (x wavenumber = alphaD), strength coefficient
    SIGCTE*ratio/(mass*Z) ``coef0``, absorber density ``densm``, each
    (nl, niso); and the per-layer species-collapsed maximum line
    strength ``kmax`` (nl,) over the full line list."""
    alphal, alphad_f = _layer_widths(temps, densities, d["iso_mass"],
                                     d["iso_imol"].long(), mol_mass,
                                     mol_radius)
    coef0 = (SIGCTE * d["iso_ratio"][None, :] /
             (d["iso_mass"][None, :] * Z.T))
    densm = densities[d["iso_imol"].long(), :].T
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
    return {"alphal": alphal.contiguous(), "alphad_f": alphad_f.contiguous(),
            "coef0": coef0.contiguous(), "densm": densm.contiguous(),
            "kmax": kmax.contiguous()}


def _tile_chunks(plan: FastPlan, d, tab, temps, wn_i: float, dwn: float,
                 ethresh: float, nwidth: float):
    """Walk the tiles in chunks whose (layer, tile, bin, line) volume stays
    under PLAIN_ELEMENTS elements.  Yields (t0, t1, k, x, y, inv, use) for
    tiles t0:t1: the line strength x density k (nl, tc, L), 0 where the
    line is masked or dropped by the ethresh cut; the Voigt arguments x
    (nl, tc, tw, L) and y, and 1/alphaD inv, both (nl, tc, 1, L); and
    ``use`` (nl, tc, tw, L), a kept line inside its wing."""
    nl = temps.shape[0]
    ntiles, lmax = d["wavn"].shape
    tw = plan.tw
    dtype, device = d["wavn"].dtype, d["wavn"].device
    T = temps[:, None, None]
    kthr = (ethresh * tab["kmax"])[:, None, None]
    bins = torch.arange(tw, device=device).to(dtype)
    step = max(1, PLAIN_ELEMENTS // max(1, nl * tw * lmax))
    for t0 in range(0, ntiles, step):
        t1 = min(ntiles, t0 + step)
        wv = d["wavn"][t0:t1]                               # (tc, L)
        el = d["elow"][t0:t1]
        iso = d["iso"][t0:t1].long()
        msk = d["mask"][t0:t1]
        aL = tab["alphal"][:, iso]                          # (nl, tc, L)
        aDf = tab["alphad_f"][:, iso]
        cf0 = tab["coef0"][:, iso]
        dens = tab["densm"][:, iso]

        k0 = (d["gf"][t0:t1] * torch.exp(-EXPCTE * el / T) *
              (1.0 - torch.exp(-EXPCTE * wv / T)) * cf0)
        keep = msk & (k0 >= kthr)
        k = torch.where(keep, k0 * dens, 0.0)

        aD = aDf * wv
        inv = 1.0 / aD
        y = SQRTLN2 * aL * inv
        tile = torch.arange(t0, t1, device=device).to(dtype)
        # The kernel's bin wavenumber, wn_i + dwn*(tile*tw) + dwn*bin:
        wn_col = (wn_i + dwn * (tile * tw))[:, None] + (dwn * bins)[None, :]
        dist = (wn_col[:, :, None] - wv[:, None, :]).abs()  # (tc, tw, L)
        inv = inv[:, :, None, :]
        x = SQRTLN2 * dist[None] * inv                      # (nl, tc, tw, L)
        wing = nwidth * torch.maximum(aD, aL)
        use = (dist[None] <= wing[:, :, None, :]) & keep[:, :, None, :]
        yield t0, t1, k, x, y[:, :, None, :], inv, use


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
    """Extinction (nlayer, n_coarse) through the CUDA line-tile kernel.

    Same arguments as pallas_extinction: the plan, its device arrays
    (fast.fast_device_arrays), layer temperatures (cgs), densities
    (nmol, nl), partition functions Z (niso, nl) and the molecules'
    masses and radii.  A CPU tensor takes :func:`plain_extinction`; a
    CUDA tensor launches the kernel, which takes float32 only.
    """
    if d["wavn"].device.type == "cpu":
        return plain_extinction(plan, d, temps, densities, Z, mol_mass,
                                mol_radius, wn_i, dwn, ethresh, nwidth)
    tab = layer_tables(d, temps, densities, Z, mol_mass, mol_radius)
    return line_tile_extinction(plan, d, tab, temps, wn_i, dwn, ethresh,
                                nwidth)


def line_tile_extinction(plan: FastPlan, d, tab, temps, wn_i: float,
                         dwn: float, ethresh: float, nwidth: float):
    """Launch ``line_tile_extinction`` (csrc/line_tile.cu) on the line
    tiles ``d`` and the per-layer tables ``tab`` (:func:`layer_tables`)
    -> extinction (nlayer, n_coarse), float32 on the tiles' CUDA device.
    Raises on any other device, type or shape, and when the launch
    fails."""
    from transit_tpu_torch.opacities._build import load_library

    if plan.class_tiles is not None:
        raise NotImplementedError(
            "tile classes come with the banded-plan slice")
    lines = {k: d[k] for k in ("wavn", "elow", "gf", "iso", "mask")}
    args = {**lines, **tab, "temps": temps}
    device = d["wavn"].device
    if device.type != "cuda":
        raise ValueError(f"line_tile_extinction runs on CUDA tensors, "
                         f"not {device}")
    for name, t in args.items():
        want = {"iso": torch.int32, "mask": torch.bool}.get(name,
                                                           torch.float32)
        if t.dtype != want:
            raise TypeError(f"line_tile_extinction: {name} is {t.dtype}, "
                            f"the kernel takes {want}")
        if t.device != device:
            raise ValueError(f"line_tile_extinction: {name} is on "
                             f"{t.device}, the line tiles on {device}")
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
    out = torch.empty((nl, plan.n_coarse), dtype=torch.float32,
                      device=device)
    if nl == 0 or plan.n_coarse == 0:
        return out
    # Lines to walk per tile: up to the last unmasked one.
    pos = torch.arange(1, lmax + 1, dtype=torch.int32, device=device)
    tile_nlines = (lines["mask"] * pos).amax(dim=1).to(torch.int32)
    args = {k: v.contiguous() for k, v in args.items()}

    with torch.cuda.device(device):
        lib = load_library()
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.line_tile_extinction(
            *(ctypes.c_void_p(args[k].data_ptr())
              for k in ("wavn", "elow", "gf", "iso", "mask")),
            ctypes.c_void_p(tile_nlines.data_ptr()),
            *(ctypes.c_void_p(args[k].data_ptr())
              for k in ("temps", "alphal", "alphad_f", "coef0", "densm",
                        "kmax")),
            ctypes.c_void_p(out.data_ptr()),
            nl, ntiles, lmax, niso, plan.tw, plan.n_coarse,
            wn_i, dwn, ethresh, nwidth, -EXPCTE,
            ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"line_tile_extinction failed to launch: CUDA "
                           f"error {err}")
    line_tile_extinction.launches += 1
    return out


# Kernel launches since the last reset (a plain count; set it to 0 to
# start a new count).
line_tile_extinction.launches = 0
