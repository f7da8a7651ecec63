"""The shell kernel's launch layout (opacities/kernel_shell.py shell_band,
opacities/banded.py banded_index and launch_units) on the CPU: one
launch per band takes all its decimated shells, through a block table
over the shells' lines packed tile by tile.  On the fixture (no
decimated shell), the fine-grid fixture (two bands, 4 and 2 shells, tw
512 and 128) and the hot-Jupiter plan at 0.05 cm-1 (band 0: asym2 shells
at strides 2 and 4, 743 tiles)."""

import numpy as np
import pytest
import torch

from tests.test_conformance import make_config
from tests.test_torch_common import (fine_grid_config, hotjupiter_config,
                                     port_config, state)
from transit_tpu_torch.model import TransitModel
from transit_tpu_torch.opacities import banded, kernel_shell

torch.set_num_threads(1)

CONFIGS = {"fixture": lambda: make_config("eclipse", 1e30),
           "fine": fine_grid_config,
           "hj0.05": lambda: hotjupiter_config(0.05)}


def _model(name, dtype=torch.float32):
    return TransitModel(port_config(CONFIGS[name]()), dtype=dtype,
                        device="cpu", bands=6)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_block_table_covers_each_shell_tile_once(name):
    """Every (shell, tile) of a band's decimated shells with a line is
    listed exactly once, with the tile's own line count, and its packed
    lines are the class row's lines in order; a tile with no line in any
    shell gets no block; blocks go heaviest first."""
    m = _model(name)
    index = banded.banded_index(m.bplan, m.bdev, "cpu")
    units = list(banded.launch_units(m.bplan, m.bdev, index))
    nshell_launch = sum(part == "shell" for _, part, _ in units)
    assert nshell_launch == sum(b is not None for b in index["shells"])
    assert nshell_launch == (0 if name == "fixture" else
                             1 if name == "hj0.05" else 2)
    for i, band in enumerate(index["shells"]):
        if band is None:
            continue
        parts = [(p, c, s) for bi, _, part, p, c, s in
                 banded.band_parts(m.bplan, m.bdev) if bi == i and
                 part == "shell"]
        assert [(p, s) for p, _, s in band.parts] == \
            [(p, s) for p, _, s in parts]
        table = band.blocks.numpy()
        assert len(set(table[:, 0].tolist())) == table.shape[0]
        tw, nt = parts[0][0].tw, parts[0][0].ntiles
        work = sum(table[:, 2 + 2 * si] * (tw // s + 3)
                   for si, (_, _, s) in enumerate(parts))
        assert (work > 0).all() and (np.diff(work) <= 0).all()
        rows_of = {}                     # (shell, tile) -> class row
        cnt = np.zeros((len(parts), nt), dtype=np.int64)
        for si, (plan, classes, _) in enumerate(parts):
            for dc, gidx in classes:
                g = np.arange(plan.ntiles) if gidx is None else gidx
                cnt[si, g] = dc["mask"].sum(dim=1).numpy()
                for row, tile in enumerate(g):
                    rows_of[si, int(tile)] = (dc, row)
        assert len(rows_of) == len(parts) * nt
        assert sorted(table[:, 0].tolist()) == \
            np.nonzero(cnt.sum(axis=0))[0].tolist()
        for entry in table:
            tile = int(entry[0])
            for si in range(len(parts)):
                off, n = entry[1 + 2 * si: 3 + 2 * si]
                assert n == cnt[si, tile]
                dc, row = rows_of[si, tile]
                for k in ("wavn", "elow", "gf", "iso"):
                    assert torch.equal(band.lines[k][off:off + n],
                                       dc[k][row, :n])
        # Every line of the shells is packed once.
        total = sum(int(dc["mask"].sum()) for _, c, _ in parts
                    for dc, _ in c)
        assert band.lines["wavn"].shape[0] == total
        assert table[:, 2::2].sum() == total


@pytest.mark.parametrize("name", ["fine", "hj0.05"])
def test_banded_counts_unchanged(name):
    """banded_counts' shell work equals what the block table hands the
    kernel (one chain per band row and packed line), and on the
    hot-Jupiter plan at 0.05 cm-1 the counts the shell kernel's counters
    gave on the card (PERF.md, float32)."""
    m = _model(name)
    args, kw = state(m, np.float32)
    targs = [torch.as_tensor(a) for a in args]
    tab = banded.prep_layers(m.bdev[0], *targs, use_kernel=False)
    index = banded.banded_index(m.bplan, m.bdev, "cpu")
    chains = sum(len(index["rows"][i]) * int(b.blocks[:, 2::2].sum())
                 for i, b in enumerate(index["shells"]) if b is not None)
    if name == "fine":
        got = banded.banded_counts(m.bplan, m.bdev, tab, targs[0], **kw)
        assert got == {"line_tile": {"chains": 8209, "live": 7192,
                                     "pairs": 347007},
                       "shell": {"chains": 1338, "live": 1160,
                                 "evals": 85272}}
        assert got["shell"]["chains"] == chains
        return
    # The hot-Jupiter plan: only its shells are counted here (the
    # line-tile count of 100 layers at 0.05 cm-1 takes minutes here).
    got = {"chains": 0, "live": 0, "evals": 0}
    for i, rows, part, plan, classes, stride in banded.band_parts(m.bplan,
                                                                  m.bdev):
        if part != "shell":
            continue
        sel = torch.as_tensor(rows)
        tab_r = {k: v[sel] for k, v in tab.items()}
        for dc, gidx in classes:
            c = kernel_shell.shell_counts(plan, dc, tab_r, targs[0][sel],
                                          stride=stride, gidx=gidx, **kw)
            for k, v in c.items():
                got[k] += v
    assert got == {"chains": 1100100, "live": 911780, "evals": 84286124}
    assert got["chains"] == chains


def _packed_field(band, tab, temps, kw, nrows, n_coarse, full_res):
    """The shells' field computed block by block from the packed lines
    and the block table alone (what the kernel reads), in float64."""
    out = torch.zeros((nrows, n_coarse), dtype=temps.dtype)
    for row in band.blocks.numpy():
        tile = int(row[0])
        for si, (plan, _, stride) in enumerate(band.parts):
            off, n = int(row[1 + 2 * si]), int(row[2 + 2 * si])
            if n == 0:
                continue
            d = {k: band.lines[k][None, off:off + n]
                 for k in ("wavn", "elow", "gf", "iso")}
            d["mask"] = torch.ones((1, n), dtype=torch.bool)
            val = kernel_shell.plain_shell_tiles(
                plan, d, tab, temps, stride=1 if full_res else stride,
                gidx=np.array([tile]), **kw)[:, 0]
            cols = torch.arange(tile * plan.tw, (tile + 1) * plan.tw)
            keep = cols < n_coarse
            out[:, cols[keep]] += val[:, keep]
    return out


@pytest.mark.parametrize("full_res", [False, True])
def test_packed_lines_give_the_plain_field(full_res):
    """The block table and packed lines carry the shells' whole input:
    the field summed block by block from them equals plain_shell_band
    (the class tensors) in float64, on every band's rows."""
    m = _model("fine", torch.float64)
    args, kw = state(m, np.float64)
    targs = [torch.as_tensor(a) for a in args]
    tab = banded.prep_layers(m.bdev[0], *targs, use_kernel=False)
    index = banded.banded_index(m.bplan, m.bdev, "cpu")
    n_coarse = m.bplan.plans[0].n_coarse
    seen = 0
    for i, band in enumerate(index["shells"]):
        if band is None:
            continue
        rows = index["rows"][i]
        sel = rows.long()
        want = torch.zeros((targs[0].shape[0], n_coarse),
                           dtype=torch.float64)
        kernel_shell.plain_shell_band(band, tab, targs[0], rows=rows,
                                      out=want, full_res=full_res, **kw)
        got = _packed_field(band, {k: v[sel] for k, v in tab.items()},
                            targs[0][sel], kw, len(rows), n_coarse,
                            full_res)
        assert float(want[sel].abs().max()) > 0
        err = ((got - want[sel]).abs() /
               (want[sel].abs() + 1e-6 * want[sel].abs().max())).max()
        assert float(err) <= 1e-12
        seen += 1
    assert seen == 2
