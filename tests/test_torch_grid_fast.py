"""The port's fast opacity-grid build (opacities/grid.py
build_opacity_grid_fast: per output molecule a banded plan over all
(layer, temperature) cells and the banded function at unit density)
against transit_tpu's build_opacity_grid_fast on the conformance
fixture, float64: within 1e-10 of the max.  Its per-molecule
consistency (tests/test_opacity_grid.py:69-101): every cell's rows times
the cell's densities equal the banded function at those densities within
1e-12 of the max.  Unit density changes only the density table."""

import dataclasses

import numpy as np
import pytest
import torch

from tests.test_opacity_grid import grid_config
from tests.test_torch_common import port_config
from transit_tpu.model import TransitModel as JModel
from transit_tpu.opacities import grid as jgrid
from transit_tpu_torch.model import TransitModel
from transit_tpu_torch.opacities import banded, grid

torch.set_num_threads(1)


def port_model(cfg, mode="fast", **kw):
    return TransitModel(port_config(cfg), mode=mode, dtype=torch.float64,
                        device="cpu", **kw)


def test_fast_build_equals_jax(tmp_path):
    cfg = grid_config()
    want = jgrid.build_opacity_grid_fast(JModel(cfg, mode="fast"))
    path = tmp_path / "fast.bin"
    got = grid.build_opacity_grid_fast(port_model(cfg), str(path))
    for k in ("molID", "temp", "press", "wns"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
    assert got.grid.shape == want.grid.shape == (20, 11, 1, 101)
    scale = np.abs(want.grid).max()
    assert scale > 0
    assert np.abs(got.grid - want.grid).max() <= 1e-10 * scale
    np.testing.assert_array_equal(grid.read_opacity_grid(str(path)).grid,
                                  got.grid)


@pytest.mark.parametrize("ethresh", [1e-30, 1e-8])
def test_fast_build_is_permol_consistent(ethresh):
    """Every cell's rows times the cell's densities equal the banded
    function of the same plan at the cell's real densities (the
    density inside the line sum), within 1e-12 of the max: the
    unit-density plumbing (tests/test_opacity_grid.py:69-101 checks
    JAX's against its unbanded fast function, which in the port is the
    line-tile kernel's Pallas formulation, not fast.fast_extinction)."""
    cfg = port_config(grid_config())
    cfg.ethreshold = ethresh
    m = port_model(cfg)
    cells = grid.grid_cells(m)
    plans = grid.fast_plans(m, cells)
    og = grid.build_opacity_grid_fast(m, plans=plans)
    (mp,) = plans
    t = m._t
    temps = t(cells.tt)
    tab = banded.prep_layers(mp.devs[0], temps, t(cells.dd), t(cells.zz),
                             m._molm_t, m._molrad_t, use_kernel=False)
    direct = banded.plain_bands(mp.bplan, mp.devs, tab, temps, dict(
        wn_i=m.wns.i, dwn=m.wns.d, ethresh=ethresh,
        nwidth=cfg.nwidth)).numpy()
    ids = list(m.mol.ids)
    dens_m = cells.dd[[ids.index(int(mid)) for mid in og.molID]]
    coll = np.einsum("cmw,mc->cw", og.grid.reshape(-1, *og.grid.shape[2:]),
                     dens_m)
    assert np.abs(direct).max() > 0
    np.testing.assert_allclose(coll, direct,
                               atol=np.abs(direct).max() * 1e-12)


def test_unit_density_changes_only_the_density_table():
    m = port_model(grid_config(), bands=6)
    t = m._t(m.atm.temp)
    args = (m.bdev[0], t * m.atm.tfct, m._t(m.atm.d), m.partition(t),
            m._molm_t, m._molrad_t)
    real = banded.prep_layers(*args, use_kernel=False)
    unit = banded.prep_layers(*args, use_kernel=False, unit_density=True)
    assert real.keys() == unit.keys()
    for k in real:
        if k == "densm":
            assert torch.equal(unit[k], torch.ones_like(real[k]))
            assert not torch.equal(real[k], unit[k])
        else:
            assert torch.equal(real[k], unit[k]), k


def test_fast_plans_per_molecule():
    """One plan per output molecule with lines, banded over every cell
    (4 bands at most), and rows in the model's dtype."""
    m = port_model(grid_config())
    cells = grid.grid_cells(m)
    plans = grid.fast_plans(m, cells)
    assert [p.m for p in plans] == [0]
    bp = plans[0].bplan
    assert 1 <= len(bp.slices) <= 4
    assert sorted(bp.perm.tolist()) == list(range(cells.tt.shape[0]))
    rows = grid.fast_rows(m, cells, plans[0])
    assert rows.dtype == torch.float64 and rows.shape == (220, m.wns.n)
    assert dataclasses.is_dataclass(cells) and cells.dd.shape == (
        len(m.mol.mass), 220)
