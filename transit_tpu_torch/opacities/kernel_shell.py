"""Decimated far-wing shells through the CUDA shell kernel — the counterpart
of transit_tpu.opacities.fast._run_tiles with ``stride > 1`` (or
``far_full_res``) on a shell plan that carries a line weight
(fast.py:437-574, 690-837: ``_cr_weights``, ``_upsample_cr``,
``_line_halo_weight``, ``_block_lines`` and ``_block_primal``'s
line-weighted branch; the backward, ``_block_val_bwd`` with a line
weight, fast.py:608-680).  In JAX this is jnp code, not Pallas.

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
:func:`plain_shell_tiles` the plain function of one shell class.  The
backward: :func:`shell_tile_backward` (``shell_tile_backward`` of the same
source, with the forward launch's clip mask) and its plain version
:func:`plain_shell_vjp`, class by class.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from transit_tpu_torch.constants import SQRTLN2, EXPCTE
from transit_tpu_torch.opacities.fast import FastPlan
from transit_tpu_torch.opacities.kernel_lbl import (PLAIN_ELEMENTS,
                                                    _check_acc, _check_cuda,
                                                    _check_stats, _ptr,
                                                    block_lines, chain_vjp,
                                                    plain_classes,
                                                    voigt_bin_sums,
                                                    zero_grads)
from transit_tpu_torch.opacities.voigt import FAR_KERNELS, RAW_W, WFN_CODE


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
    line) elements.  Yields (t0, t1, L, wl, k, inv, y, x_raw):
    kernel_lbl.block_lines' dict L of the chunk's first lines (L stops at
    the chunk's longest line list) and their halo weight wl (tc, L); the
    weighted strength k and 1/alphaD, y, each (nl, tc, L); the Voigt
    argument x_raw (nl, tc, ne, L) at the tiles' evaluation points, which
    fast._block_primal clamps at 1e8."""
    nl = temps.shape[0]
    nt, lmax = d["wavn"].shape
    ne = _points(plan.tw, stride)
    dtype, device = d["wavn"].dtype, d["wavn"].device
    step = max(1, PLAIN_ELEMENTS[temps.device.type] //
               max(1, nl * ne * lmax))
    for t0 in range(0, nt, step):
        t1 = min(nt, t0 + step)
        tile = (torch.arange(t0, t1, device=device) if gidx is None else
                torch.as_tensor(gidx[t0:t1], device=device)).to(dtype)
        n = max(1, int(d["mask"][t0:t1].sum(dim=1).max()))
        L = block_lines(d, t0, t1, n, tab, temps, ethresh)
        wl = _line_halo_weight(plan, L["wv"], wn_i + dwn * (tile * plan.tw),
                               dwn, nwidth)
        inv = 1.0 / (L["aDf"] * L["wv"])
        pos = _eval_points(plan.tw, stride, wn_i, dwn, tile)
        dist = (pos[:, :, None] - L["wv"][:, None, :]).abs()  # (tc, ne, L)
        yield (t0, t1, L, wl, L["kd"] * (L["dd"] * wl), inv,
               SQRTLN2 * L["aL"] * inv,
               SQRTLN2 * dist[None] * inv[:, :, None, :])


def plain_shell_tiles(plan: FastPlan, d, tab, temps, wn_i: float,
                      dwn: float, ethresh: float, nwidth: float,
                      stride: int, gidx=None):
    """The shell function on the line tensors ``d`` (nt, lmax) of one
    class (``gidx``: their global tiles; None: row i is tile i) and the
    per-layer tables ``tab`` of the layers of ``temps``: (nl, nt, tw),
    upsampled and clipped at 0 for stride > 1: one shell class of
    :func:`plain_shell_band`."""
    nl = temps.shape[0]
    nt, tw = d["wavn"].shape[0], plan.tw
    dec = torch.zeros((nl, nt, _points(tw, stride)), dtype=d["wavn"].dtype,
                      device=d["wavn"].device)
    for t0, t1, _, _, k, inv, y, x_raw in _shell_chunks(
            plan, d, tab, temps, gidx, wn_i, dwn, ethresh, nwidth, stride):
        dec[:, t0:t1] = _point_sums(plan, k, inv, y, x_raw)
    if stride == 1:
        return dec
    return torch.clamp_min(_upsample_cr(dec, stride, tw), 0.0)


def _point_sums(plan: FastPlan, k, inv, y, x_raw):
    """One chunk's field at its evaluation points, (nl, tc, ne)."""
    inv4 = inv[:, :, None, :]
    prof = FAR_KERNELS[plan.wfn_tag](torch.clamp_max(x_raw, 1e8),
                                     y[:, :, None, :]) * inv4
    return (prof * k[:, :, None, :]).sum(dim=3)


def upsample_cr_t(gb, stride: int, tw: int):
    """The transpose of :func:`_upsample_cr`: a cotangent (..., tw) at the
    bins -> (..., tw//stride + 3) at the points (bin g*stride + r took
    W[m, r] of point g + m)."""
    G = tw // stride
    W = torch.as_tensor(_cr_weights(stride), dtype=gb.dtype, device=gb.device)
    gg = gb.reshape(gb.shape[:-1] + (G, stride))
    out = gb.new_zeros(gb.shape[:-1] + (G + 3,))
    for m in range(4):
        out[..., m:m + G] += gg @ W[m]
    return out


def plain_shell_vjp(plan: FastPlan, d, tab, temps, g, wn_i: float,
                    dwn: float, ethresh: float, nwidth: float, stride: int,
                    gidx=None, grads=None) -> dict:
    """The VJP of :func:`plain_shell_tiles`: the cotangent ``g`` (nl, nt,
    tw) of one shell class's field -> the cotangents of ``temps`` (nl,)
    and of the tables ``coef0``, ``densm``, ``alphal`` and ``alphad_f``
    (nl, niso), float64 sums (kernel_lbl.zero_grads; added into
    ``grads`` when given), w in the tensors' dtype and the sums in
    float64 as in kernel_lbl.plain_line_tiles_vjp.  fast._block_val_bwd with the halo
    weight wl folded into k (so the density's cotangent is x wl,
    fast.py:673) and no wing mask, behind the transpose of the
    Catmull-Rom upsampling; for stride > 1 the cotangent passes only
    where the shell's own upsampled field is > 0 (the clip of
    fast.py:836), which it recomputes per chunk of tiles.  The plain
    PyTorch version of :func:`shell_tile_backward`."""
    grads = zero_grads(tab, temps) if grads is None else grads
    for t0, t1, L, wl, k, inv, y, x_raw in _shell_chunks(
            plan, d, tab, temps, gidx, wn_i, dwn, ethresh, nwidth, stride):
        gp = g[:, t0:t1]
        if stride > 1:
            with torch.no_grad():
                up = _upsample_cr(_point_sums(plan, k, inv, y, x_raw),
                                  stride, plan.tw)
            gp = upsample_cr_t(torch.where(up > 0, gp, 0.0), stride,
                               plan.tw)
        B = torch.where(L["keep"][:, :, None, :], gp[..., None], 0.0)
        chain_vjp(L, inv, k, voigt_bin_sums(RAW_W[plan.wfn_tag], x_raw,
                                            y[:, :, None, :], B),
                  temps, grads, wl=wl[None])
    return grads


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
    for _, _, L, _, k, *_ in _shell_chunks(plan, d, tab, temps, gidx, wn_i,
                                           dwn, ethresh, nwidth, stride):
        out["chains"] += temps.shape[0] * int(L["mask"].sum())
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


def _shell_launch(fn: str, band: ShellBand, tab, temps, rows, full_res,
                  extra: dict):
    """Check one shell-kernel launch's arguments: returns (device, its
    tensors made contiguous, the host (stride, wfn) spec, nl, niso, tw,
    n_coarse, nrows, nblk)."""
    plans = [p for p, _, _ in band.parts]
    for plan in plans:
        if plan.wfn_tag not in ("r2", "asym2"):
            raise ValueError(f"{fn}: Voigt function {plan.wfn_tag!r}; the "
                             f"kernel has r2 and asym2")
    idx = {"blocks": band.blocks, **({} if rows is None else
                                     {"rows": rows})}
    args = {**band.lines, **tab, "temps": temps, **idx,
            **{k: v for k, v in extra.items() if v is not None}}
    device = _check_cuda(fn, args, ints=("iso", "blocks", "rows"))
    nl = temps.shape[0]
    niso = tab["alphal"].shape[1]
    for name in ("alphal", "alphad_f", "coef0", "densm"):
        if tuple(tab[name].shape) != (nl, niso):
            raise ValueError(f"{fn}: {name} has shape "
                             f"{tuple(tab[name].shape)}")
    if tuple(tab["kmax"].shape) != (nl,):
        raise ValueError(f"{fn}: kmax must be (nl,)")
    tw, n_coarse = plans[0].tw, plans[0].n_coarse
    strides = [1 if full_res else s for _, _, s in band.parts]
    for s in strides:
        if s < 1 or s & (s - 1) or tw % s:
            raise ValueError(f"{fn}: stride {s} is not a power of two "
                             f"dividing the tile width {tw}")
    if max(_points(tw, s) for s in strides) > 2048 or len(strides) > 8:
        raise ValueError(f"{fn}: more than 2048 points per tile or 8 "
                         f"shells")
    nrows = nl if rows is None else rows.shape[0]
    spec = [v for s, p in zip(strides, plans)
            for v in (s, WFN_CODE[p.wfn_tag])]
    return (device, {k: v.contiguous() for k, v in args.items()}, spec, nl,
            niso, tw, n_coarse, nrows, band.blocks.shape[0])


def shell_tile_extinction(band: ShellBand, tab, temps, wn_i: float,
                          dwn: float, ethresh: float, nwidth: float, *,
                          rows=None, out, stats=None,
                          full_res: bool = False, clip=None):
    """Launch ``shell_tile_extinction`` (csrc/shell_tile.cu) once for the
    decimated shells of ``band``: add each shell's field, shell after
    shell, into the layer rows ``rows`` (int32 indices into ``temps`` and
    ``tab``; None: all) of ``out`` (nlayer, n_coarse), float32 on the
    card, in place; returns ``out``.  ``full_res`` evaluates the shells at
    every bin (stride 1: no upsampling, no clip).  ``stats``, a (3,) int64
    tensor on the card, gets the kernel's counters added
    (:func:`shell_counts`, summed over the shells' classes).  ``clip``, a
    (nshell, nrows, n_coarse) uint8 tensor, gets each decimated shell's
    mask of bins whose upsampled field was > 0 before the clip, which
    :func:`shell_tile_backward` takes.  Raises on any other device, type
    or shape, and when the launch fails."""
    from transit_tpu_torch.opacities._build import load_library

    device, args, spec, nl, niso, tw, n_coarse, nrows, nblk = _shell_launch(
        "shell_tile_extinction", band, tab, temps, rows, full_res,
        {"clip": clip})
    if (out.dtype != torch.float32 or out.device != device or
            tuple(out.shape) != (nl, n_coarse) or not out.is_contiguous()):
        raise ValueError(f"shell_tile_extinction: out must be a contiguous "
                         f"({nl}, {n_coarse}) float32 tensor on {device}")
    if clip is not None and (tuple(clip.shape) != (len(band.parts), nrows,
                                                   n_coarse) or
                             not clip.is_contiguous()):
        raise ValueError("shell_tile_extinction: clip must be a contiguous "
                         "(nshell, nrows, n_coarse) uint8 tensor")
    _check_stats("shell_tile_extinction", stats, device)
    if nrows == 0 or nblk == 0:
        return out
    aL_max, aDf_max = band.parts[0][0].line_weight
    with torch.cuda.device(device):
        lib = load_library()
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.shell_tile_extinction(
            *(_ptr(args[k]) for k in ("wavn", "elow", "gf", "iso", "blocks")),
            _ptr(args.get("rows")),
            *(_ptr(args[k]) for k in ("temps", "alphal", "alphad_f", "coef0",
                                      "densm", "kmax")),
            _ptr(out), _ptr(clip), _ptr(stats), nrows, nblk, len(spec) // 2,
            (ctypes.c_int * len(spec))(*spec), niso, tw, n_coarse, wn_i,
            dwn, ethresh, nwidth, aL_max, aDf_max, tw * dwn, -EXPCTE,
            ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"shell_tile_extinction failed to launch: CUDA "
                           f"error {err}")
    shell_tile_extinction.launches += 1
    return out


def shell_tile_backward(band: ShellBand, tab, temps, g, wn_i: float,
                        dwn: float, ethresh: float, nwidth: float, *,
                        clip, rows=None, acc=None, full_res: bool = False):
    """Launch ``shell_tile_backward`` (csrc/shell_tile.cu), the backward of
    one :func:`shell_tile_extinction` launch with the same arguments and
    its ``clip`` mask (None only with ``full_res``): ``g`` (nlayer,
    n_coarse) float32, the cotangent of the output, gives per layer the
    cotangents of ``temps`` and of the tables, added in float64 into
    ``acc`` (nlayer, 1 + 4 niso) (kernel_lbl.acc_grads splits it; made
    here, zero, when None); returns ``acc``.  :func:`plain_shell_vjp`,
    shell by shell, is its plain version.  Raises on any other device,
    type or shape, and when the launch fails."""
    from transit_tpu_torch.opacities._build import load_library

    device, args, spec, nl, niso, tw, n_coarse, nrows, nblk = _shell_launch(
        "shell_tile_backward", band, tab, temps, rows, full_res,
        {"g": g, "clip": clip})
    if tuple(g.shape) != (nl, n_coarse):
        raise ValueError("shell_tile_backward: g must be (nl, n_coarse)")
    if not full_res and (clip is None or tuple(clip.shape) != (
            len(band.parts), nrows, n_coarse)):
        raise ValueError("shell_tile_backward: the forward's clip mask "
                         "(nshell, nrows, n_coarse) is needed")
    if niso > 64:
        raise ValueError(f"shell_tile_backward: {niso} > 64 isotopes")
    acc = _check_acc("shell_tile_backward", acc, nl, niso, device)
    if nrows == 0 or nblk == 0:
        return acc
    aL_max, aDf_max = band.parts[0][0].line_weight
    with torch.cuda.device(device):
        lib = load_library()
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.shell_tile_backward(
            *(_ptr(args[k]) for k in ("wavn", "elow", "gf", "iso", "blocks")),
            _ptr(args.get("rows")),
            *(_ptr(args[k]) for k in ("temps", "alphal", "alphad_f", "coef0",
                                      "densm", "kmax", "g")),
            _ptr(args.get("clip")), _ptr(acc), nrows, nblk, len(spec) // 2,
            (ctypes.c_int * len(spec))(*spec), niso, tw, n_coarse, wn_i,
            dwn, ethresh, nwidth, aL_max, aDf_max, tw * dwn, -EXPCTE,
            ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"shell_tile_backward failed to launch: CUDA "
                           f"error {err}")
    shell_tile_backward.launches += 1
    return acc


# Kernel launches since the last reset (a plain count; set it to 0 to
# start a new count).
shell_tile_extinction.launches = 0
shell_tile_backward.launches = 0
