"""Decimated far-wing shells through the CUDA shell kernel — the counterpart
of transit_tpu.opacities.fast._run_tiles with ``stride > 1`` (or
``far_full_res``) on a shell plan that carries a line weight
(fast.py:437-574, 690-837: ``_cr_weights``, ``_upsample_cr``,
``_line_halo_weight``, ``_block_lines`` and ``_block_primal``'s
line-weighted branch, forward only).  In JAX this is jnp code, not Pallas.

For each tile, layer and evaluation point (tw/stride + 3 points spaced
stride*dwn from one stride before the tile) the function sums over the
tile's lines k wl K(x, y) / alphaD, with

  * k = gf e^(-c2 El/T) (1 - e^(-c2 nu/T)) coef0 dens, 0 where the line is
    masked or k0 < ethresh * kmax;
  * wl the smooth per-(line, tile) halo weight (1 inside 0.875 halos of
    the band, 0 beyond 1.125), and no per-layer wing cutoff;
  * K the shell's Voigt function (``wfn_tag``: r2 or asym2);

then Catmull-Rom upsamples the points to the tw bins and clips at 0
(stride 1: the tw bins themselves, no upsampling).  JAX's register
layouts (``lanes``) do not change the function; the plain version here
uses one layout for all.

The kernel takes a band's decimated shells in one launch: a
:class:`ShellBand` (made once per model by :func:`shell_band`) packs the
shells' lines tile by tile and lists the tiles a launch's blocks take.
On a CUDA tensor :func:`shell_tile_extinction` launches
``shell_tile_extinction`` of csrc/shell_tile.cu, or raises;
:func:`plain_shell_band` is its plain PyTorch version and
:func:`plain_shell_tiles` the plain function of one shell class.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from transit_tpu_torch.constants import SQRTLN2, EXPCTE
from transit_tpu_torch.opacities.fast import FastPlan
from transit_tpu_torch.opacities.kernel_lbl import (PLAIN_ELEMENTS,
                                                    _check_cuda,
                                                    _check_stats,
                                                    plain_classes)
from transit_tpu_torch.opacities.voigt import FAR_KERNELS, WFN_CODE


def _cr_weights(stride: int) -> np.ndarray:
    """(4, stride) Catmull-Rom (Keys a=-1/2) interpolation weights for
    in-group offsets r = 0..stride-1 at fractions u = r/stride
    (fast.py:437)."""
    u = np.arange(stride) / stride
    return np.stack([-0.5 * u**3 + u**2 - 0.5 * u,
                     1.5 * u**3 - 2.5 * u**2 + 1.0,
                     -1.5 * u**3 + 2.0 * u**2 + 0.5 * u,
                     0.5 * u**3 - 0.5 * u**2])


def _upsample_cr(x, stride: int, tw: int):
    """Catmull-Rom upsample of decimated tile rows (..., tw//stride+3) ->
    (..., tw) (fast.py:447): sample k sits at bin (k-1)*stride, so bin
    g*stride+r interpolates from samples g..g+3, summed in that order."""
    G = tw // stride
    W = torch.as_tensor(_cr_weights(stride), dtype=x.dtype, device=x.device)
    out = x[..., 0:G, None] * W[0]
    for m in range(1, 4):
        out = out + x[..., m:m + G, None] * W[m]
    return out.reshape(x.shape[:-1] + (tw,))


def _line_halo_weight(plan: FastPlan, wv, tile_lo, dwn: float,
                      nwidth: float):
    """Smooth per-(tile, line) halo weight (fast.py:487): a smoothstep
    from 1 at 0.875 to 0 at 1.125 times halo(tile) =
    nwidth*max(aL_max, aDf_max*tile_hi) + dwn, of the line's distance from
    the tile.  wv (tc, L), tile_lo (tc,) -> (tc, L)."""
    aL_max, aDf_max = plan.line_weight
    tile_hi = tile_lo + float(plan.tw * dwn)
    halo_t = nwidth * torch.clamp_min(aDf_max * tile_hi, aL_max) + dwn
    d_line = torch.clamp_min(torch.maximum(tile_lo[:, None] - wv,
                                           wv - tile_hi[:, None]), 0.0)
    v = torch.clamp((1.125 * halo_t[:, None] - d_line) /
                    (0.25 * halo_t[:, None]), 0.0, 1.0)
    return v * v * (3.0 - 2.0 * v)


def _eval_points(tw: int, stride: int, wn_i: float, dwn: float, tile):
    """Evaluation points (tc, ne) of tiles ``tile`` (float global
    indices), rounded as fast._run_tiles rounds them:
    (wn_i + (dwn*stride)*(e - 1)) + dwn*(tile*tw) for stride > 1, and the
    tw bins (wn_i + dwn*e) + dwn*(tile*tw) for stride 1."""
    off, ne = (1.0 if stride > 1 else 0.0), _points(tw, stride)
    e = torch.arange(ne, device=tile.device).to(tile.dtype)
    axis = wn_i + dwn * stride * (e - off)
    return axis[None, :] + (dwn * (tile * tw))[:, None]


def _points(tw: int, stride: int) -> int:
    """Evaluation points per tile of a shell at ``stride``."""
    return tw // stride + 3 if stride > 1 else tw


def _shell_chunks(plan: FastPlan, d, tab, temps, gidx, wn_i: float,
                  dwn: float, ethresh: float, nwidth: float, stride: int):
    """Walk the tiles in chunks under PLAIN_ELEMENTS (layer, tile, point,
    line) elements.  Yields (t0, t1, k, inv, y, pos, wv, mask): the
    weighted strength k and 1/alphaD, y, each (nl, tc, L); the tiles'
    evaluation points pos (tc, ne), line wavenumbers wv and line mask
    (tc, L).  L stops at the chunk's longest line list."""
    nl = temps.shape[0]
    nt, lmax = d["wavn"].shape
    ne = _points(plan.tw, stride)
    dtype, device = d["wavn"].dtype, d["wavn"].device
    T = temps[:, None, None]
    kthr = (tab["kmax"] * ethresh)[:, None, None]
    step = max(1, PLAIN_ELEMENTS[temps.device.type] //
               max(1, nl * ne * lmax))
    for t0 in range(0, nt, step):
        t1 = min(nt, t0 + step)
        tile = (torch.arange(t0, t1, device=device) if gidx is None else
                torch.as_tensor(gidx[t0:t1], device=device)).to(dtype)
        tile_lo = wn_i + dwn * (tile * plan.tw)
        n = max(1, int(d["mask"][t0:t1].sum(dim=1).max()))
        mask = d["mask"][t0:t1, :n]
        wv = d["wavn"][t0:t1, :n]
        iso = d["iso"][t0:t1, :n].long()
        wl = _line_halo_weight(plan, wv, tile_lo, dwn, nwidth)
        k0 = (d["gf"][t0:t1, :n] *
              torch.exp(-EXPCTE * d["elow"][t0:t1, :n] / T) *
              (1.0 - torch.exp(-EXPCTE * wv / T)) * tab["coef0"][:, iso])
        keep = mask & (k0 >= kthr)
        k = torch.where(keep, k0, 0.0) * (tab["densm"][:, iso] * wl)
        inv = 1.0 / (tab["alphad_f"][:, iso] * wv)
        y = SQRTLN2 * tab["alphal"][:, iso] * inv
        yield (t0, t1, k, inv, y,
               _eval_points(plan.tw, stride, wn_i, dwn, tile), wv, mask)


def plain_shell_tiles(plan: FastPlan, d, tab, temps, wn_i: float,
                      dwn: float, ethresh: float, nwidth: float,
                      stride: int, gidx=None):
    """The shell function on the line tensors ``d`` (nt, lmax) of one
    class (``gidx``: their global tiles; None: row i is tile i) and the
    per-layer tables ``tab`` of the layers of ``temps``: (nl, nt, tw),
    upsampled and clipped at 0 for stride > 1: one shell class of
    :func:`plain_shell_band`."""
    voigt = FAR_KERNELS[plan.wfn_tag]
    nl = temps.shape[0]
    nt, tw = d["wavn"].shape[0], plan.tw
    ne = _points(tw, stride)
    dec = torch.zeros((nl, nt, ne), dtype=d["wavn"].dtype,
                      device=d["wavn"].device)
    for t0, t1, k, inv, y, pos, wv, _ in _shell_chunks(
            plan, d, tab, temps, gidx, wn_i, dwn, ethresh, nwidth, stride):
        dist = (pos[:, :, None] - wv[:, None, :]).abs()       # (tc, ne, L)
        inv4 = inv[:, :, None, :]
        x = torch.clamp_max(SQRTLN2 * dist[None] * inv4, 1e8)
        prof = voigt(x, y[:, :, None, :]) * inv4
        dec[:, t0:t1] = (prof * k[:, :, None, :]).sum(dim=3)
    if stride == 1:
        return dec
    return torch.clamp_min(_upsample_cr(dec, stride, tw), 0.0)


def shell_counts(plan: FastPlan, d, tab, temps, wn_i: float, dwn: float,
                 ethresh: float, nwidth: float, stride: int,
                 gidx=None) -> dict:
    """The shell kernel's own work on this data: ``chains``, the
    (layer, tile, line) strength chains of unmasked lines; ``live``, the
    kept ones with a nonzero weighted strength; ``evals``, their
    (layer, point, line) Voigt evaluations, live x points — all of them
    needed by the function."""
    ne = _points(plan.tw, stride)
    out = {"chains": 0, "live": 0, "evals": 0}
    for t0, t1, k, *_, mask in _shell_chunks(plan, d, tab, temps, gidx, wn_i,
                                             dwn, ethresh, nwidth, stride):
        out["chains"] += temps.shape[0] * int(mask.sum())
        out["live"] += int((k != 0).sum())
    out["evals"] = out["live"] * ne
    return out


def plain_shell_classes(plan: FastPlan, classes, tab, temps, wn_i: float,
                        dwn: float, ethresh: float, nwidth: float,
                        stride: int):
    """The shell function of every tile of ``plan`` from its classes
    [(line tensors, global tiles or None)]: (nl, ntiles * tw)."""
    return plain_classes(plan, classes, temps, lambda dc, gidx:
                         plain_shell_tiles(plan, dc, tab, temps, wn_i, dwn,
                                           ethresh, nwidth, stride,
                                           gidx=gidx))


@dataclasses.dataclass
class ShellBand:
    """The decimated shells of one band, as one shell-kernel launch takes
    them.  ``parts``: [(plan, classes, stride)] in plan order, the
    classes' line tensors those of the plain version; ``lines``: the
    shells' lines packed tile by tile (each tile's lines of each shell
    contiguous, in line order), "wavn", "elow", "gf" and int32 "iso";
    ``blocks``: (nblk, 1 + 2 nshell) int32, per tile with lines its
    global index, then per shell the offset and count of its lines in
    ``lines``, heaviest tiles first."""
    parts: list
    lines: dict
    blocks: torch.Tensor


def shell_band(parts) -> ShellBand:
    """Pack the decimated shells ``parts`` [(plan, classes, stride)] of
    one band (their class tensors, on their device) for the shell
    kernel.  The shells share the band's tiles, tile width and line
    weight."""
    p0 = parts[0][0]
    for plan, _, _ in parts:
        if (plan.tw, plan.ntiles, plan.n_coarse, plan.line_weight) != \
                (p0.tw, p0.ntiles, p0.n_coarse, p0.line_weight) or \
                plan.line_weight is None:
            raise ValueError("shell_band: the shells of a band share tiles "
                             "and a line weight")
    ns = len(parts)
    table = np.zeros((p0.ntiles, 1 + 2 * ns), dtype=np.int64)
    table[:, 0] = np.arange(p0.ntiles)
    packed = {k: [] for k in ("wavn", "elow", "gf", "iso")}
    base = 0
    for si, (plan, classes, _) in enumerate(parts):
        for dc, gidx in classes:
            cnt = dc["mask"].sum(dim=1).cpu().numpy()
            g = (np.arange(cnt.shape[0]) if gidx is None else
                 np.asarray(gidx))
            table[g, 1 + 2 * si] = base + np.cumsum(cnt) - cnt
            table[g, 2 + 2 * si] = cnt
            for k in packed:
                packed[k].append(dc[k][dc["mask"]])
            base += int(cnt.sum())
    work = sum(table[:, 2 + 2 * si] * _points(p0.tw, s)
               for si, (_, _, s) in enumerate(parts))
    keep = np.nonzero(work > 0)[0]
    table = table[keep[np.argsort(-work[keep], kind="stable")]]
    lines = {k: torch.cat(v) for k, v in packed.items()}
    return ShellBand(parts=list(parts), lines=lines,
                     blocks=torch.as_tensor(table.astype(np.int32),
                                            device=lines["iso"].device))


def plain_shell_band(band: ShellBand, tab, temps, wn_i: float, dwn: float,
                     ethresh: float, nwidth: float, *, rows=None, out,
                     full_res: bool = False):
    """The plain PyTorch version of :func:`shell_tile_extinction`: add
    each shell's field, shell after shell, into the rows ``rows`` (None:
    all) of ``out`` (nl, n_coarse), in place; returns ``out``."""
    sel = (torch.arange(temps.shape[0], device=temps.device) if rows is None
           else rows.long())
    tab_r = {k: v[sel] for k, v in tab.items()}
    n = out.shape[1]
    for plan, classes, stride in band.parts:
        val = plain_shell_classes(plan, classes, tab_r, temps[sel], wn_i,
                                  dwn, ethresh, nwidth,
                                  1 if full_res else stride)
        out[sel] = out[sel] + val[:, :n]
    return out


def shell_tile_extinction(band: ShellBand, tab, temps, wn_i: float,
                          dwn: float, ethresh: float, nwidth: float, *,
                          rows=None, out, stats=None,
                          full_res: bool = False):
    """Launch ``shell_tile_extinction`` (csrc/shell_tile.cu) once for the
    decimated shells of ``band``: add each shell's field, shell after
    shell, into the layer rows ``rows`` (int32 indices into ``temps`` and
    ``tab``; None: all) of ``out`` (nlayer, n_coarse), float32 on the
    card, in place; returns ``out``.  ``full_res`` evaluates the shells at
    every bin (stride 1: no upsampling, no clip).  ``stats``, a (3,) int64
    tensor on the card, gets the kernel's counters added
    (:func:`shell_counts`, summed over the shells' classes).  Raises on
    any other device, type or shape, and when the launch fails."""
    from transit_tpu_torch.opacities._build import load_library

    plans = [p for p, _, _ in band.parts]
    for plan in plans:
        if plan.wfn_tag not in ("r2", "asym2"):
            raise ValueError(f"shell_tile_extinction: Voigt function "
                             f"{plan.wfn_tag!r}; the kernel has r2 and "
                             f"asym2")
    idx = {"blocks": band.blocks, **({} if rows is None else
                                     {"rows": rows})}
    args = {**band.lines, **tab, "temps": temps, **idx}
    device = _check_cuda("shell_tile_extinction", args,
                         ints=("iso", "blocks", "rows"))
    nl = temps.shape[0]
    niso = tab["alphal"].shape[1]
    for name in ("alphal", "alphad_f", "coef0", "densm"):
        if tuple(tab[name].shape) != (nl, niso):
            raise ValueError(f"shell_tile_extinction: {name} has shape "
                             f"{tuple(tab[name].shape)}")
    if tuple(tab["kmax"].shape) != (nl,):
        raise ValueError("shell_tile_extinction: kmax must be (nl,)")
    tw, n_coarse = plans[0].tw, plans[0].n_coarse
    strides = [1 if full_res else s for _, _, s in band.parts]
    for s in strides:
        if s < 1 or s & (s - 1) or tw % s:
            raise ValueError(f"shell_tile_extinction: stride {s} is not a "
                             f"power of two dividing the tile width {tw}")
    if max(_points(tw, s) for s in strides) > 2048 or len(strides) > 8:
        raise ValueError("shell_tile_extinction: more than 2048 points "
                         "per tile or 8 shells")
    if (out.dtype != torch.float32 or out.device != device or
            tuple(out.shape) != (nl, n_coarse) or not out.is_contiguous()):
        raise ValueError(f"shell_tile_extinction: out must be a contiguous "
                         f"({nl}, {n_coarse}) float32 tensor on {device}")
    _check_stats("shell_tile_extinction", stats, device)
    nrows = nl if rows is None else rows.shape[0]
    nblk = band.blocks.shape[0]
    if nrows == 0 or nblk == 0:
        return out
    args = {k: v.contiguous() for k, v in args.items()}
    spec = [v for s, p in zip(strides, plans) for v in (s, WFN_CODE[p.wfn_tag])]

    def ptr(t):
        return ctypes.c_void_p(None if t is None else t.data_ptr())

    aL_max, aDf_max = plans[0].line_weight
    with torch.cuda.device(device):
        lib = load_library()
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.shell_tile_extinction(
            *(ptr(args[k]) for k in ("wavn", "elow", "gf", "iso", "blocks")),
            ptr(args.get("rows")),
            *(ptr(args[k]) for k in ("temps", "alphal", "alphad_f", "coef0",
                                     "densm", "kmax")),
            ptr(out), ptr(stats), nrows, nblk, len(strides),
            (ctypes.c_int * len(spec))(*spec), niso, tw, n_coarse, wn_i,
            dwn, ethresh, nwidth, aL_max, aDf_max, tw * dwn, -EXPCTE,
            ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"shell_tile_extinction failed to launch: CUDA "
                           f"error {err}")
    shell_tile_extinction.launches += 1
    return out


# Kernel launches since the last reset (a plain count; set it to 0 to
# start a new count).
shell_tile_extinction.launches = 0
