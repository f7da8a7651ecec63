"""The port's exact opacity-grid build (opacities/grid.py
build_opacity_grid: all (layer, temperature) cells as pseudo-layers of
lbl.layer_groups(nm=...) and the per-molecule profile scatter) against
transit_tpu's build_opacity_grid on the conformance fixture
(tests/test_opacity_grid.py:19-44), float64, the port's model given
JAX's profile table: within 1e-12 of the max, the C golden grid at that
test's tolerances (rtol 5e-5, atol 1e-10 max), the same grid whatever
the chunk of cells, and the file written.  The per-molecule scatter with
one molecule adds what the collapsed one adds, bit for bit."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from tests.test_conformance import GOLD
from tests.test_opacity_grid import grid_config
from tests.test_torch_common import port_config
from transit_tpu.model import TransitModel as JModel
from transit_tpu.opacities import grid as jgrid
from transit_tpu_torch.model import TransitModel
from transit_tpu_torch.opacities import grid, lbl
from transit_tpu_torch.opacities.voigt import ProfileTable

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pair():
    """JAX's exact fixture model and its grid; the port's model of the
    same configuration on JAX's profile table (float64, CPU)."""
    cfg = grid_config()
    jm = JModel(cfg)
    m = TransitModel(port_config(cfg), dtype=torch.float64, device="cpu",
                     table=ProfileTable(**dataclasses.asdict(jm.table)))
    return jm, jgrid.build_opacity_grid(jm), m


@pytest.fixture(scope="module")
def built(pair):
    return grid.build_opacity_grid(pair[2])


def test_exact_build_equals_jax(pair, built):
    _, want, _ = pair
    for k in ("molID", "temp", "press", "wns"):
        np.testing.assert_array_equal(getattr(built, k), getattr(want, k))
    assert built.grid.shape == want.grid.shape == (20, 11, 1, 101)
    scale = np.abs(want.grid).max()
    assert scale > 0
    assert np.abs(built.grid - want.grid).max() <= 1e-12 * scale


def test_exact_build_matches_c_golden(built):
    ref = grid.read_opacity_grid(os.path.join(GOLD, "ref_opacity_grid.bin"))
    np.testing.assert_allclose(built.temp, ref.temp)
    np.testing.assert_allclose(built.press, ref.press, rtol=1e-12)
    np.testing.assert_allclose(built.wns, ref.wns, rtol=1e-12)
    np.testing.assert_array_equal(built.molID, ref.molID)
    np.testing.assert_allclose(built.grid, ref.grid, rtol=5e-5,
                               atol=ref.grid.max() * 1e-10)


@pytest.mark.parametrize("cell_batch", [1, 17])
def test_exact_build_chunks_agree(pair, built, cell_batch, tmp_path):
    path = tmp_path / "g.bin"
    og = grid.build_opacity_grid(pair[2], str(path), cell_batch=cell_batch)
    np.testing.assert_array_equal(og.grid, built.grid)
    back = grid.read_opacity_grid(str(path))
    np.testing.assert_array_equal(back.grid, built.grid)
    np.testing.assert_array_equal(back.molID, built.molID)


def test_exact_build_refuses_a_fast_model(pair):
    m = TransitModel(port_config(grid_config()), mode="fast",
                     dtype=torch.float64, device="cpu")
    with pytest.raises(ValueError, match="exact-mode"):
        grid.build_opacity_grid(m)


def test_permol_scatter_with_one_molecule_is_the_collapsed_one(pair):
    """The plain per-molecule scatter with nm = 1 (every tile on row 0)
    on the group tables of the file atmosphere equals the collapsed
    scatter bit for bit; the tile molecules are checked."""
    m = pair[2]
    t = m._t(m.atm.temp)
    grp = lbl.layer_groups(m.dev, t * m.atm.tfct, m._t(m.atm.d),
                           m.partition(t), m._molm_t, m._molrad_t,
                           wn0=float(m.wns.v[0]), ethresh=m.cfg.ethreshold)
    s = lbl.scatter_tables(m.plan, m.dev)
    s1 = lbl.permol_tables(s, m.dev["line_iout"], m.dev["g_primary"], 1)
    assert s1.nm == 1 and s1.tile_mol.dtype == torch.int32
    args = (grp["g_k"], grp["g_idop"], grp["ilor"])
    a = lbl.profile_scatter_plain(*args, s)
    b = lbl.profile_scatter_plain(*args, s1)
    assert b.shape == (a.shape[0], 1, a.shape[1]) and float(a.max()) > 0
    assert torch.equal(a, b[:, 0])
    with pytest.raises(ValueError, match=r"\[0, 0\)"):
        lbl.permol_tables(s, m.dev["line_iout"], m.dev["g_primary"], 0)
