"""The backward kernels' launch layout on the CPU (opacities/banded.py
backward_units, kernel_lbl.LineBand): one line_tile_backward
launch per band takes all the band's near and stride-1 shell classes
through a class table, and one shell_tile_backward launch its decimated
shells.  The table is checked on the planner's output (the fixture, the
fine-grid fixture, the hot-Jupiter plans at 0.5 and 0.05 cm-1, and the
batched view of forward_batch), and the orchestration is rehearsed with
the backward wrappers replaced by fakes that add the plain VJPs."""

import collections

import numpy as np
import pytest
import torch

from tests.test_conformance import make_config
from tests.test_torch_common import (fine_grid_config, hotjupiter_config,
                                     port_config, state)
from transit_tpu_torch.model import TransitModel
from transit_tpu_torch.opacities import banded, kernel_lbl, kernel_shell

torch.set_num_threads(1)

CONFIGS = {"fixture": lambda: make_config("eclipse", 1e30),
           "fine": fine_grid_config,
           "hj0.5": hotjupiter_config,
           "hj0.05": lambda: hotjupiter_config(0.05)}


def _model(name, dtype=torch.float32):
    return TransitModel(port_config(CONFIGS[name]()), mode="fast", dtype=dtype,
                        device="cpu", bands=6)


def backward_blocks(band):
    """The grid of one line_tile_backward launch over ``band``, as the
    kernel reads its class table (csrc/line_tile.cu): per block (grid x)
    its class (index into ``band.units``), its row of the class's line
    tensors and its global tile, an (nblk, 3) array.  A class's blocks
    follow the previous class's; a row is its tile unless the class has
    tiles."""
    out = []
    for c, (_, d, gidx, _) in enumerate(band.units):
        n = d["wavn"].shape[0]
        t = np.arange(n) if gidx is None else np.asarray(gidx, np.int64)
        out.append(np.stack([np.full(n, c), np.arange(n), t], axis=1))
    return np.concatenate(out)


def _units_tiles(units):
    """(class tensors' id, global tile) of every row of the line-tile
    units [(plan, line tensors, gidx, tiles)]."""
    out = collections.Counter()
    for _, dc, gidx, _ in units:
        n = dc["wavn"].shape[0]
        for t in (range(n) if gidx is None else np.asarray(gidx).tolist()):
            out[id(dc), int(t)] += 1
    return out


@pytest.mark.parametrize("name", list(CONFIGS) + ["hj0.5_batch2"])
def test_class_table_covers_each_class_tile_once(name):
    """Per band one line_tile_backward launch, then one shell launch when
    the band has decimated shells; the launch's blocks (as the kernel
    reads its class table) cover every (class, tile) of the band's
    forward line-tile launches (launch_units) exactly once, with the
    class's own tile index; at most MAX_CLASSES classes a launch.  The
    batched view (forward_batch, B = 2) launches the same table on its
    own rows: band i's rows are both members' copies of band i's
    layers."""
    m = _model(name.split("_")[0])
    bplan, index = m.bplan, banded.banded_index(m.bplan, m.bdev, "cpu")
    if name.endswith("batch2"):
        m.bindex = index                 # as a model on the card holds it
        bplan, index = m._batched_bplan(2)
        nl = m.atm.nlayers
        for (a, b), r in zip(m.bplan.slices, index["rows"]):
            band = m.bplan.perm[a:b]
            assert r.tolist() == np.concatenate([band, band + nl]).tolist()
    fwd = collections.defaultdict(list)
    for i, part, unit in banded.launch_units(bplan, m.bdev, index):
        if part != "shell":
            fwd[i].append(unit)
    seen = []
    for i, part, unit in banded.backward_units(bplan, m.bdev, index):
        seen.append((i, part))
        if part == "shell":
            assert unit is index["shells"][i]
            continue
        units = unit.units
        assert 0 < len(units) <= kernel_lbl.MAX_CLASSES
        assert [u[1] for u in units] == [u[1] for u in fwd[i]]
        blocks = backward_blocks(unit)
        got = collections.Counter((id(units[c][1]), int(t))
                                  for c, _, t in blocks.tolist())
        want = _units_tiles(units)
        assert got == want and set(got.values()) == {1}
        for c, r, t in blocks.tolist():
            gidx = units[c][2]
            assert t == (r if gidx is None else int(gidx[r]))
    bands = len(bplan.slices)
    assert seen == [x for i in range(bands) for x in
                    [(i, "lines")] + ([(i, "shell")] if
                                      index["shells"][i] is not None
                                      else [])]


def _add_acc(acc, sel, grads, niso):
    """Add the float64 sums ``grads`` of the rows ``sel`` into the
    kernels' (nl, 1 + 4 niso) layout."""
    acc[sel, 0] += grads["temps"]
    for i, k in enumerate(("coef0", "densm", "alphal", "alphad_f")):
        acc[sel, 1 + i * niso:1 + (i + 1) * niso] += grads[k]


@pytest.mark.parametrize("far_full_res", [False, True])
@pytest.mark.parametrize("config", ["fixture", "fine"])
def test_backward_launches_match_plain_vjp(monkeypatch, config,
                                           far_full_res):
    """BandedOp(kernel=True) through LineExtinction: the forward's
    launches (banded._launch_all) with every kernel replaced by its plain
    version, and the backward's (one line_tile_backward per band over its
    classes, one shell_tile_backward per band with decimated shells)
    replaced by fakes that add the plain VJPs into the float64 sums; the
    cotangents equal plain_bands_vjp's (float64, to 1e-12 of max: sums in
    another order)."""
    m = _model(config, torch.float64)
    seen = {"lines": [], "shell": 0}

    def line_fwd(plan, d, tab, temps, wn_i, dwn, ethresh, nwidth,
                 stats=None, *, tiles, rows, out, accumulate, bins_first):
        sel = rows.long()
        val = kernel_lbl.plain_line_tiles(
            plan, d, {k: v[sel] for k, v in tab.items()}, temps[sel], wn_i,
            dwn, ethresh, nwidth, gidx=tiles, bins_first=bins_first)
        cols = ((tiles.long() if tiles is not None else
                 torch.arange(plan.ntiles))[:, None] * plan.tw +
                torch.arange(plan.tw)).flatten()
        keep = cols < out.shape[1]
        v = val.reshape(sel.shape[0], -1)[:, keep]
        r, c = sel[:, None], cols[keep][None, :]
        out[r, c] = out[r, c] + v if accumulate else v

    def shell_fwd(band, tab, temps, wn_i, dwn, ethresh, nwidth, *, rows,
                  out, stats=None, full_res, clip=None):
        kernel_shell.plain_shell_band(band, tab, temps, wn_i, dwn, ethresh,
                                      nwidth, rows=rows, out=out,
                                      full_res=full_res)

    def line_bwd(band, tab, temps, g, wn_i, dwn, ethresh, nwidth, *, rows,
                 bins_first, acc):
        sel, niso = rows.long(), tab["alphal"].shape[1]
        acc = (torch.zeros((temps.shape[0], 1 + 4 * niso),
                           dtype=torch.float64) if acc is None else acc)
        tab_r = {k: v[sel] for k, v in tab.items()}
        for plan, dc, gidx, tiles in band.units:
            gt = kernel_lbl.tile_cotangent(g[sel], plan)
            grads = kernel_lbl.plain_line_tiles_vjp(
                plan, dc, tab_r, temps[sel],
                gt if gidx is None else gt[:, tiles.long()], wn_i, dwn,
                ethresh, nwidth, gidx=gidx, bins_first=bins_first)
            _add_acc(acc, sel, grads, niso)
        seen["lines"].append(len(band.units))
        return acc

    def shell_bwd(band, tab, temps, g, wn_i, dwn, ethresh, nwidth, *, clip,
                  rows, acc, full_res):
        sel, niso = rows.long(), tab["alphal"].shape[1]
        acc = (torch.zeros((temps.shape[0], 1 + 4 * niso),
                           dtype=torch.float64) if acc is None else acc)
        tab_r = {k: v[sel] for k, v in tab.items()}
        for plan, classes, stride in band.parts:
            gt = kernel_lbl.tile_cotangent(g[sel], plan)
            for dc, gidx in classes:
                grads = kernel_shell.plain_shell_vjp(
                    plan, dc, tab_r, temps[sel],
                    gt if gidx is None else gt[:, torch.as_tensor(
                        gidx).long()], wn_i, dwn, ethresh, nwidth,
                    stride=1 if full_res else stride, gidx=gidx)
                _add_acc(acc, sel, grads, niso)
        seen["shell"] += 1
        return acc

    monkeypatch.setattr(banded, "line_tile_extinction", line_fwd)
    monkeypatch.setattr(banded, "shell_tile_extinction", shell_fwd)
    monkeypatch.setattr(banded, "layer_kmax", kernel_lbl.plain_kmax)
    monkeypatch.setattr(banded, "line_tile_backward", line_bwd)
    monkeypatch.setattr(banded, "shell_tile_backward", shell_bwd)
    args, kw = state(m, np.float64)
    targs = [torch.as_tensor(a) for a in args]
    index = banded.banded_index(m.bplan, m.bdev, "cpu")
    tab = banded.band_tables(m.bdev[0], *targs)
    leaves = {k: tab[k].clone().requires_grad_(True)
              for k in ("coef0", "densm", "alphal", "alphad_f")}
    temps = targs[0].clone().requires_grad_(True)
    op = banded.BandedOp(m.bplan, m.bdev, index, kw, far_full_res,
                         kernel=True)
    out = kernel_lbl.line_extinction(op, temps, leaves["coef0"],
                                     leaves["densm"], leaves["alphal"],
                                     leaves["alphad_f"])
    g = torch.as_tensor(np.random.default_rng(5).standard_normal(
        tuple(out.shape)))
    got = dict(zip(("temps", "coef0", "densm", "alphal", "alphad_f"),
                   torch.autograd.grad((out * g).sum(),
                                       [temps, *leaves.values()])))
    ref_tab = {**{k: v.detach() for k, v in leaves.items()},
               "kmax": kernel_lbl.plain_kmax(m.bdev[0], targs[0],
                                             tab["coef0"], floor=0.0)}
    want = banded.plain_bands_vjp(m.bplan, m.bdev, ref_tab, targs[0], g, kw,
                                  far_full_res)
    for k, b in want.items():
        a = got[k]
        assert float(b.abs().max()) > 0, k
        assert float((a - b).abs().max()) <= 1e-12 * float(b.abs().max()), k
    assert len(seen["lines"]) == len(m.bplan.slices)
    assert max(seen["lines"]) > 1       # a launch took several classes
    assert seen["shell"] == sum(b is not None for b in index["shells"])
    assert (seen["shell"] > 0) == (config == "fine")


def test_backward_launch_refuses_too_many_classes():
    """A launch's class table holds at most MAX_CLASSES classes; more
    raise before anything is launched."""
    m = _model("fixture")
    index = banded.banded_index(m.bplan, m.bdev, "cpu")
    _, _, band = next(banded.backward_units(m.bplan, m.bdev, index))
    args, kw = state(m, np.float32)
    tab = banded.prep_layers(m.bdev[0], *(torch.as_tensor(a) for a in args),
                             use_kernel=False)
    g = torch.zeros((m.atm.nlayers, band.units[0][0].n_coarse))
    with pytest.raises(ValueError, match="tile classes"):
        kernel_lbl.line_tile_backward(
            kernel_lbl.LineBand(band.units * (kernel_lbl.MAX_CLASSES + 1)),
            tab, torch.as_tensor(args[0]), g, **kw)
