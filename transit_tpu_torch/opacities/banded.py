"""Line extinction on the layer-banded plan — the counterpart of
transit_tpu.opacities.fast.banded_extinction (fast.py:1202-1245) with
its per-layer prep (``_prep_layers``, ``_kmax_scan``, fast.py:336-419)
and, for the gradient, the analytic VJP of its tile blocks
(``_block_val_bwd``, fast.py:608-680).

Per band (a slice of the width-sorted layers) the extinction is the near
plan's tiles plus, in order, each far-wing shell's:
``ex = near + shell_1 + shell_2 + ...``.  A near plan and a stride-1
shell are the line-tile function (per-layer wing cutoff; Voigt w4, or
r2 on a shell); a decimated shell is the shell function (halo weight,
Catmull-Rom upsampling).  A plan with tile classes runs class by class.

:func:`banded_kernel_extinction` runs it on the card: one ``layer_kmax``
launch, then per band the line-tile kernel for every near class and
every stride-1 shell class, each writing (near) or adding (shells) its
band's rows and its tiles' columns of one (nl, n_coarse) output in
place, and one shell-kernel launch that adds all the band's decimated
shells, shell after shell.
It is differentiable (kernel_lbl.LineExtinction with :class:`BandedOp`):
the backward runs, per band, one ``line_tile_backward`` launch over all
the band's near and stride-1 classes and one ``shell_tile_backward``
launch over its decimated shells (:func:`backward_units`).
:func:`plain_banded_extinction` is the plain PyTorch version; on the CPU
and with ``use_kernel=False`` the same Function runs it forward and the
plain VJPs backward.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from transit_tpu_torch.constants import SIGCTE
from transit_tpu_torch.opacities.fast import BandedPlan, FastPlan
from transit_tpu_torch.opacities.kernel_lbl import (LineBand,
                                                    acc_grads, cast_grads,
                                                    layer_kmax,
                                                    line_extinction,
                                                    line_tile_backward,
                                                    line_tile_extinction,
                                                    plain_classes,
                                                    plain_kmax,
                                                    plain_line_tiles,
                                                    plain_line_tiles_vjp,
                                                    run_counts,
                                                    tile_cotangent,
                                                    width_tables,
                                                    zero_grads)
from transit_tpu_torch.opacities.kernel_shell import (plain_shell_classes,
                                                      plain_shell_vjp,
                                                      shell_band,
                                                      shell_counts,
                                                      shell_tile_backward,
                                                      shell_tile_extinction)


def band_tables(d, temps, densities, Z, mol_mass, mol_radius,
                unit_density: bool = False):
    """The (nl, niso) tables of all layers (fast._prep_layers), torch
    ops: the widths and density (:func:`width_tables`; ``unit_density``:
    a density of 1, the opacity-grid build's) and the strength
    coefficient SIGCTE*ratio/mass/Z in fast.py:364's order.  The kmax
    scan reads no density, so it is the same either way."""
    coef0 = ((SIGCTE * d["iso_ratio"] / d["iso_mass"])[None, :] /
             Z.T).contiguous()
    return {**width_tables(d, temps, densities, mol_mass, mol_radius,
                           unit_density=unit_density),
            "coef0": coef0}


def band_kmax(d, temps, coef0, use_kernel: bool):
    """The kmax scan with its carry starting at 0 (fast._kmax_scan):
    ``layer_kmax`` with floor 0 when ``use_kernel``, else
    :func:`plain_kmax`."""
    return (layer_kmax if use_kernel else plain_kmax)(d, temps, coef0,
                                                      floor=0.0)


def prep_layers(d, temps, densities, Z, mol_mass, mol_radius,
                use_kernel: bool, unit_density: bool = False):
    """Per-layer tables of all layers, once per step (fast._prep_layers):
    :func:`band_tables` and the kmax scan (:func:`band_kmax`)."""
    tab = band_tables(d, temps, densities, Z, mol_mass, mol_radius,
                      unit_density=unit_density)
    return {**tab, "kmax": band_kmax(d, temps, tab["coef0"], use_kernel)}


def plan_classes(plan: FastPlan, d):
    """[(line tensors, global tile indices (numpy int32) or None)] per
    tile class of ``plan`` (one entry when it has no classes)."""
    if plan.class_tiles is None:
        return [({k: d[k] for k in ("wavn", "elow", "gf", "iso", "mask")},
                 None)]
    return list(zip(d["classes"], plan.class_tiles))


def band_parts(bplan: BandedPlan, devs, far_full_res: bool = False):
    """The launches of the banded function, band by band, in JAX's order
    of sums: yields (band, rows (numpy), part, plan, classes, stride)
    with part "near", "s1" (a stride-1 shell: the line-tile function) or
    "shell" (a decimated shell, evaluated at ``stride``; 1 with
    ``far_full_res``)."""
    for i, ((a, b), plan, d) in enumerate(zip(bplan.slices, bplan.plans,
                                              devs)):
        rows = bplan.perm[a:b]
        yield i, rows, "near", plan, plan_classes(plan, d), 1
        far = bplan.far_plans[i] if bplan.far_plans is not None else None
        for (fp, _, s), (fdt, _) in zip(far or [], d.get("far", [])):
            if fp.line_weight is None:
                yield i, rows, "s1", fp, plan_classes(fp, fdt), 1
            else:
                yield (i, rows, "shell", fp, plan_classes(fp, fdt),
                       1 if far_full_res else s)


def _plain_part(part, plan, classes, tab, temps, stride, kw):
    """One part's (nrows, ntiles*tw) extinction, class by class, on the
    band's rows of ``tab`` and ``temps``."""
    if part == "shell":
        return plain_shell_classes(plan, classes, tab, temps, stride=stride,
                                   **kw)
    return plain_classes(plan, classes, temps, lambda dc, gidx:
                         plain_line_tiles(plan, dc, tab, temps, gidx=gidx,
                                          bins_first=True, **kw))


def plain_banded_extinction(bplan: BandedPlan, devs, temps, densities, Z,
                            mol_mass, mol_radius, wn_i: float, dwn: float,
                            ethresh: float, nwidth: float,
                            far_full_res: bool = False, kmax_override=None):
    """Extinction (nlayer, n_coarse) on the banded plan, in plain PyTorch
    on the tensors' device (fast.banded_extinction): per band the near
    plan plus its shells, in JAX's order, rows in the file's layer
    order.  ``far_full_res`` evaluates the decimated shells at every bin
    (same weighting, no upsampling).  ``kmax_override`` (the multi-process
    path's global kmax) is not ported yet and raises.  Autograd runs
    through it (the tests' oracle for the plain VJPs)."""
    _refuse_kmax_override(kmax_override)
    tab = prep_layers(devs[0], temps, densities, Z, mol_mass, mol_radius,
                      use_kernel=False)
    return plain_bands(bplan, devs, tab, temps,
                       dict(wn_i=wn_i, dwn=dwn, ethresh=ethresh,
                            nwidth=nwidth), far_full_res)


def _refuse_kmax_override(kmax_override):
    if kmax_override is not None:
        raise NotImplementedError(
            "kmax_override is not ported to transit_tpu_torch yet; it "
            "comes with the multi-process bands slice (see ROADMAP.md)")


def plain_bands(bplan: BandedPlan, devs, tab, temps, kw: dict,
                far_full_res: bool = False):
    """The banded function on the tables ``tab`` of all layers (with
    kmax): the body of :func:`plain_banded_extinction`."""
    n_coarse = bplan.plans[0].n_coarse
    out = torch.empty((temps.shape[0], n_coarse), dtype=temps.dtype,
                      device=temps.device)
    band, ex, sel = None, None, None
    for i, rows, part, plan, classes, stride in band_parts(
            bplan, devs, far_full_res):
        if i != band:
            if ex is not None:
                out[sel] = ex[:, :n_coarse]
            band = i
            sel = torch.as_tensor(rows, device=temps.device)
            ex = None
        tab_r = {k: v[sel] for k, v in tab.items()}
        val = _plain_part(part, plan, classes, tab_r, temps[sel], stride,
                          kw)
        ex = val if ex is None else ex + val
    out[sel] = ex[:, :n_coarse]
    return out


def plain_bands_vjp(bplan: BandedPlan, devs, tab, temps, g, kw: dict,
                    far_full_res: bool = False) -> dict:
    """The VJP of :func:`plain_bands`: the cotangent ``g`` (nl, n_coarse)
    -> the cotangents of ``temps`` and of the tables, float64 sums
    (kernel_lbl.zero_grads), part by part on the band's rows
    (kernel_lbl.plain_line_tiles_vjp, kernel_shell.plain_shell_vjp)."""
    grads = zero_grads(tab, temps)
    for _, rows, part, plan, classes, stride in band_parts(
            bplan, devs, far_full_res):
        sel = torch.as_tensor(rows, device=temps.device)
        tab_r = {k: v[sel] for k, v in tab.items()}
        gr = zero_grads(tab_r, temps[sel])
        gt = tile_cotangent(g[sel], plan)
        for dc, gidx in classes:
            gc = gt if gidx is None else gt[:, torch.as_tensor(
                gidx, device=gt.device).long()]
            if part == "shell":
                plain_shell_vjp(plan, dc, tab_r, temps[sel], gc,
                                stride=stride, gidx=gidx, grads=gr, **kw)
            else:
                plain_line_tiles_vjp(plan, dc, tab_r, temps[sel], gc,
                                     gidx=gidx, bins_first=True, grads=gr,
                                     **kw)
        for k, v in gr.items():
            grads[k].index_add_(0, sel, v)
    return grads


def banded_index(bplan: BandedPlan, devs, device):
    """The tensors of the kernel launches, on ``device``, made once per
    model: "rows", the int32 layer rows of each band; "tiles", the int32
    global tiles of each class of each near or stride-1 part, in
    :func:`band_parts` order (None for a plan without classes); "shells",
    per band the :class:`~kernel_shell.ShellBand` of its decimated shells
    (None without); "lines", per band the :class:`~kernel_lbl.LineBand`
    of its near and stride-1 classes (one backward launch)."""
    rows = [torch.as_tensor(bplan.perm[a:b], dtype=torch.int32,
                            device=device) for a, b in bplan.slices]
    tiles, shells = [], [[] for _ in bplan.slices]
    for i, _, part, plan, classes, stride in band_parts(bplan, devs):
        if part == "shell":
            shells[i].append((plan, classes, stride))
            continue
        tiles.append([None if g is None else
                      torch.as_tensor(g, dtype=torch.int32, device=device)
                      for _, g in classes])
    index = {"rows": rows, "tiles": tiles,
             "shells": [shell_band(p) if p else None for p in shells]}
    lines = [[] for _ in bplan.slices]
    for i, part, unit in launch_units(bplan, devs, index):
        if part != "shell":
            lines[i].append(unit)
    index["lines"] = [LineBand(u) for u in lines]
    return index


def launch_units(bplan: BandedPlan, devs, index):
    """The kernel launches of the banded function, in order: yields
    (band, part, unit): for part "near" or "s1" (the line-tile kernel)
    one per class, unit (plan, line tensors, global tiles (numpy or
    None), their int32 tensor); then for part "shell" one per band with
    decimated shells, unit its ShellBand."""
    tiles = iter(index["tiles"])
    for i, _, part, plan, classes, _ in band_parts(bplan, devs):
        if part != "shell":
            for (dc, gidx), t in zip(classes, next(tiles)):
                yield i, part, (plan, dc, gidx, t)
        elif index["shells"][i].parts[0][0] is plan:
            yield i, "shell", index["shells"][i]


def backward_units(bplan: BandedPlan, devs, index):
    """The backward kernel launches, band by band: yields (band, part,
    unit): part "lines", unit the band's LineBand (its near and stride-1
    classes, as :func:`launch_units` gives them), one
    ``line_tile_backward`` launch; then part "shell", unit the band's
    ShellBand, one ``shell_tile_backward`` launch."""
    for i in range(len(bplan.slices)):
        yield i, "lines", index["lines"][i]
        if index["shells"][i] is not None:
            yield i, "shell", index["shells"][i]


class BandedOp:
    """The banded plan's line extinction for kernel_lbl.LineExtinction:
    with ``kernel``, ``layer_kmax`` (floor 0) and the launches of
    :func:`launch_units` forward (:func:`_launch_all`) and those of
    :func:`backward_units` backward (:func:`_launch_all_backward`); else
    their plain versions
    (:func:`plain_bands`, :func:`plain_bands_vjp`)."""

    def __init__(self, bplan: BandedPlan, devs, index, kw: dict,
                 far_full_res: bool, kernel: bool, stats=None):
        self.bplan, self.devs, self.index, self.kw = bplan, devs, index, kw
        self.far_full_res, self.kernel = far_full_res, kernel
        self.stats = stats or {}

    def batched(self, B: int):
        """The op over B profiles' layers one after another: on the
        plan's batched view and its index (:func:`batched_view`)."""
        view, index = batched_view(self.bplan, self.index, B)
        return BandedOp(view, self.devs, index, self.kw, self.far_full_res,
                        self.kernel, self.stats)

    def kmax(self, temps, coef0):
        return band_kmax(self.devs[0], temps, coef0, self.kernel)

    def forward(self, tab, temps, grad: bool):
        if not self.kernel:
            return plain_bands(self.bplan, self.devs, tab, temps, self.kw,
                               self.far_full_res), None
        clips = None
        if grad and not self.far_full_res:
            clips = [None if b is None else torch.empty(
                (len(b.parts), r.shape[0], self.bplan.plans[0].n_coarse),
                dtype=torch.uint8, device=temps.device)
                for b, r in zip(self.index["shells"], self.index["rows"])]
        return _launch_all(self.bplan, self.devs, tab, temps, self.kw,
                           self.far_full_res, self.index, self.stats,
                           clips), clips

    def backward(self, tab, temps, g, clips):
        if not self.kernel:
            return cast_grads(plain_bands_vjp(self.bplan, self.devs, tab,
                                              temps, g, self.kw,
                                              self.far_full_res),
                              temps.dtype)
        return _launch_all_backward(self.bplan, self.devs, tab, temps, g,
                                    self.kw, self.far_full_res, self.index,
                                    clips)


def batched_view(bplan: BandedPlan, index, B: int):
    """The batched view of the banded plan and of its kernel index
    ``index`` (None on the CPU), for B profiles' layers one after another
    (transit_tpu model.py:534-555): band i of the view covers every
    member's copy of band i's layers (pseudo-layer b*nl + layer); the tile
    plans, device tensors and the index's tiles and ShellBands are
    shared, only the rows change."""
    nl = bplan.perm.shape[0]
    parts, slices, off = [], [], 0
    for a, b in bplan.slices:
        band = np.concatenate([bplan.perm[a:b] + k * nl for k in range(B)])
        parts.append(band)
        slices.append((off, off + band.shape[0]))
        off += band.shape[0]
    perm = np.concatenate(parts)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.shape[0])
    view = dataclasses.replace(bplan, perm=perm, inv_perm=inv, slices=slices)
    if index is None:
        return view, None
    device = index["rows"][0].device
    return view, {**index, "rows": [
        torch.as_tensor(r, dtype=torch.int32, device=device) for r in parts]}


def banded_kernel_extinction(bplan: BandedPlan, devs, temps, densities, Z,
                             mol_mass, mol_radius, wn_i: float, dwn: float,
                             ethresh: float, nwidth: float,
                             far_full_res: bool = False, index=None,
                             stats=None, kmax_override=None,
                             use_kernel: bool = True):
    """Extinction (nlayer, n_coarse) on the banded plan through the CUDA
    kernels (float32), differentiable in temps, densities and Z
    (kernel_lbl.LineExtinction).  CPU tensors, or ``use_kernel=False``,
    take the plain versions (the forward equals
    :func:`plain_banded_extinction`).  ``index``: :func:`banded_index`
    (made here when None).  ``stats``: optional {"line_tile": t,
    "shell": t}, (3,) int64 tensors on the card that get the forward
    kernels' counters added."""
    _refuse_kmax_override(kmax_override)
    d0 = devs[0]
    kernel = use_kernel and d0["all_wavn"].device.type == "cuda"
    if kernel and index is None:
        index = banded_index(bplan, devs, d0["all_wavn"].device)
    tab = band_tables(d0, temps, densities, Z, mol_mass, mol_radius)
    op = BandedOp(bplan, devs, index, dict(wn_i=wn_i, dwn=dwn,
                                           ethresh=ethresh, nwidth=nwidth),
                  far_full_res, kernel, stats)
    return line_extinction(op, temps, tab["coef0"], tab["densm"],
                           tab["alphal"], tab["alphad_f"])


def _launch_all(bplan, devs, tab, temps, kw, far_full_res, index, stats,
                clips=None):
    """The forward kernel launches of :func:`banded_kernel_extinction` on
    the tables ``tab`` (with kmax): one (nl, n_coarse) output; ``clips``
    (per band None or a (nshell, nrows, n_coarse) uint8 tensor) gets the
    shell launches' clip masks."""
    out = torch.empty((temps.shape[0], bplan.plans[0].n_coarse),
                      dtype=temps.dtype, device=temps.device)
    for i, part, unit in launch_units(bplan, devs, index):
        rows = index["rows"][i]
        if part == "shell":
            shell_tile_extinction(unit, tab, temps, rows=rows, out=out,
                                  stats=stats.get("shell"),
                                  full_res=far_full_res,
                                  clip=None if clips is None else clips[i],
                                  **kw)
        else:
            plan, dc, _, t = unit
            line_tile_extinction(plan, dc, tab, temps, tiles=t, rows=rows,
                                 out=out, accumulate=part == "s1",
                                 bins_first=True,
                                 stats=stats.get("line_tile"), **kw)
    return out


def _launch_all_backward(bplan, devs, tab, temps, g, kw, far_full_res,
                         index, clips):
    """The backward kernel launches of :func:`backward_units` into one
    float64 sum (nl, 1 + 4 niso), cast once (kernel_lbl.acc_grads)."""
    acc = None
    for i, part, unit in backward_units(bplan, devs, index):
        rows = index["rows"][i]
        if part == "shell":
            acc = shell_tile_backward(
                unit, tab, temps, g, clip=None if clips is None else clips[i],
                rows=rows, acc=acc, full_res=far_full_res, **kw)
        else:
            acc = line_tile_backward(unit, tab, temps, g, rows=rows,
                                     bins_first=True, acc=acc, **kw)
    if acc is None:
        return cast_grads(zero_grads(tab, temps), temps.dtype)
    return acc_grads(acc, temps.dtype)


def banded_counts(bplan: BandedPlan, devs, tab, temps, wn_i: float,
                  dwn: float, ethresh: float, nwidth: float,
                  far_full_res: bool = False) -> dict:
    """The kernels' own work on this data, counted on the host:
    {"line_tile": run_counts summed over the near and stride-1 launches,
    "shell": shell_counts summed over the decimated-shell launches}."""
    kw = dict(wn_i=wn_i, dwn=dwn, ethresh=ethresh, nwidth=nwidth)
    out = {"line_tile": {"chains": 0, "live": 0, "pairs": 0},
           "shell": {"chains": 0, "live": 0, "evals": 0}}
    for _, rows, part, plan, classes, stride in band_parts(
            bplan, devs, far_full_res):
        sel = torch.as_tensor(rows, device=temps.device)
        tab_r = {k: v[sel] for k, v in tab.items()}
        for dc, gidx in classes:
            if part == "shell":
                c = shell_counts(plan, dc, tab_r, temps[sel],
                                 stride=stride, gidx=gidx, **kw)
            else:
                c = run_counts(plan, dc, tab_r, temps[sel], gidx=gidx,
                               bins_first=True, **kw)
            key = "shell" if part == "shell" else "line_tile"
            for name, n in c.items():
                out[key][name] += n
    return out
