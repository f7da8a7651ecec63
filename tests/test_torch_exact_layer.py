"""Exact mode's layer function of the port (opacities/lbl.py
layer_extinction, the fixture's layers in one chunk) against transit_tpu's
lbl.layer_extinction (per layer under lax.map, as its model runs it),
float64, fed identical state (convert.exact_state_from_numpy of the JAX
model's plan, table and device arrays) on the conformance fixture:
within 1e-12 of each layer's max at the file's temperatures and 200 K
above and below, at the file's ethresh and at one that drops more
groups (both drop some); the Doppler-index forward fill takes each of
its branches.  The plain
scatter is the same whatever its chunk size.  The gradient of sum(w*ext)
in T, the densities and Z: tests/test_torch_exact_grad.py.

Here too, on the same fixture's JAX exact model (its profile table built
once for the file: test_torch_common.shared_jax_tables), the port's
exact opacity-grid build (opacities/grid.py build_opacity_grid: all
(layer, temperature) cells as pseudo-layers of lbl.layer_groups(nm=...)
and the per-molecule profile scatter) against transit_tpu's
build_opacity_grid (tests/test_opacity_grid.py:19-44), float64, the
port's model given JAX's profile table: within 1e-12 of the max, the C
golden grid at that test's tolerances (rtol 5e-5, atol 1e-10 max), the
same grid whatever the chunk of cells, and the file written.  The
per-molecule scatter with one molecule adds what the collapsed one adds,
bit for bit."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_conformance import GOLD, make_config
from tests.test_opacity_grid import grid_config
from tests.test_torch_common import port_config, shared_jax_tables
from transit_tpu.model import TransitModel as JModel
from transit_tpu.opacities import grid as jgrid
from transit_tpu.opacities import lbl as jlbl
from transit_tpu_torch.convert import exact_state_from_numpy
from transit_tpu_torch.model import TransitModel
from transit_tpu_torch.numerics.search import nearest_index_torch
from transit_tpu_torch.opacities import grid, lbl
from transit_tpu_torch.opacities.fast import _layer_widths
from transit_tpu_torch.opacities.voigt import ProfileTable

torch.set_num_threads(1)

ETHRESH = (1e-8, 1e-3)     # the file's, and one that drops more groups
DT = (0.0, 200.0, -200.0)  # temperature offsets, K


def jax_layers(jm, ethresh):
    """JAX's exact line extinction of every layer, (nl, nwn):
    lbl.layer_extinction under lax.map, jitted."""
    molm = jnp.asarray(jm.mol.mass)
    molr = jnp.asarray(jm.mol.radius)
    wn0 = float(jm.wns.v[0])

    def one(a):
        return jlbl.layer_extinction(jm.plan, jm.iso, jm.table, jm.dev,
                                     a[0], a[1], a[2], molm, molr, wn0,
                                     ethresh=ethresh, permol=False)[0]

    return jax.jit(lambda t, d, z: jax.lax.map(one, (t, d.T, z.T)))


def make_pair(cfg):
    """The JAX exact model of cfg and the port's (plan, device arrays)
    made from its state."""
    with shared_jax_tables():
        jm = JModel(cfg)
    plan, _, d = exact_state_from_numpy(
        dataclasses.asdict(jm.plan), dataclasses.asdict(jm.table),
        {k: np.asarray(v) for k, v in jm.dev.items()},
        dtype=torch.float64, device="cpu")
    return jm, plan, d


@pytest.fixture(scope="module")
def pair():
    return make_pair(make_config("eclipse", 1e30))


def layer_state(jm, dT):
    """(temps cgs, densities, Z, mol masses, mol radii) as numpy at the
    file's temperatures + dT (densities and Z at the file's)."""
    T = jm.atm.temp + dT
    z = np.stack([np.interp(T, t, zz) for t, zz in jm._pf])
    return (T * jm.atm.tfct, np.asarray(jm.atm.d, np.float64), z,
            np.asarray(jm.mol.mass), np.asarray(jm.mol.radius))


def port_layers(jm, plan, d, args, ethresh, **kw):
    return lbl.layer_extinction(plan, d, *(torch.as_tensor(a) for a in args),
                                wn0=float(jm.wns.v[0]), ethresh=ethresh,
                                use_kernel=False, **kw)


def fill_branches(jm, d, args, ethresh):
    """How many (layer, group) entries take each branch of the Doppler
    index's forward fill: recomputed, the run's last recomputed one, the
    layer's initial index."""
    t, dens, z, molm, molr = (torch.as_tensor(a) for a in args)
    grp = lbl.layer_groups(d, t, dens, z, molm, molr, float(jm.wns.v[0]),
                           ethresh)
    alphal, alphad = _layer_widths(t, dens, d["iso_mass"],
                                   d["iso_imol"].long(), molm, molr)
    g_iso = d["g_iso"].long()
    cond = grp["keep"] & (alphad[:, g_iso] * d["g_wavn"] /
                          alphal[:, g_iso] >= 0.1)
    ng = g_iso.shape[0]
    ff = torch.cummax(torch.where(cond, torch.arange(ng), -1), 1).values
    valid = ff >= d["g_iso_start"]
    assert torch.equal(grp["g_idop"][cond].long(), nearest_index_torch(
        d["aDop"], (alphad[:, g_iso] * d["g_wavn"])[cond]))
    return {"recomputed": int(cond.sum()),
            "filled": int((valid & ~cond).sum()),
            "initial": int((~valid & ~cond).sum()),
            "dropped": int((d["g_inrange"] & ~grp["keep"]).sum())}


@pytest.mark.parametrize("ethresh", ETHRESH)
def test_layer_extinction_matches_jax(pair, ethresh):
    jm, plan, d = pair
    fn = jax_layers(jm, ethresh)
    seen = dict.fromkeys(("recomputed", "filled", "initial", "dropped"), 0)
    for dT in DT:
        args = layer_state(jm, dT)
        ref = np.asarray(fn(*(jnp.asarray(a) for a in args[:3])))
        got = port_layers(jm, plan, d, args, ethresh).numpy()
        assert got.shape == ref.shape == (jm.atm.nlayers, jm.wns.n)
        scale = np.abs(ref).max(axis=1, keepdims=True)
        assert np.all(scale > 0)
        assert float(np.max(np.abs(got - ref) / scale)) <= 1e-12
        for k, v in fill_branches(jm, d, args, ethresh).items():
            seen[k] += v
    assert all(v > 0 for v in seen.values()), seen
    return seen


def test_plain_scatter_chunks_agree(pair):
    """The plain scatter and its VJP give the same bits in one chunk and
    in chunks of a few (layer, group) entries (they add in one order)."""
    jm, plan, d = pair
    args = layer_state(jm, 0.0)
    t, dens, z, molm, molr = (torch.as_tensor(a) for a in args)
    grp = lbl.layer_groups(d, t, dens, z, molm, molr, float(jm.wns.v[0]),
                           1e-8)
    s = lbl.scatter_tables(plan, d)
    whole = lbl.profile_scatter_plain(grp["g_k"], grp["g_idop"],
                                      grp["ilor"], s, budget=1 << 40)
    small = lbl.profile_scatter_plain(grp["g_k"], grp["g_idop"],
                                      grp["ilor"], s, budget=64)
    assert float(whole.abs().max()) > 0 and torch.equal(whole, small)
    ct = torch.as_tensor(np.random.default_rng(4).standard_normal(
        tuple(whole.shape)))
    g1 = lbl.profile_scatter_plain_vjp(ct, grp["keep"], grp["g_idop"],
                                       grp["ilor"], s, budget=1 << 40)
    g2 = lbl.profile_scatter_plain_vjp(ct, grp["keep"], grp["g_idop"],
                                       grp["ilor"], s, budget=64)
    assert float(g1.abs().max()) > 0 and torch.equal(g1, g2)
    assert lbl.scatter_pairs(grp["g_k"], grp["g_idop"], grp["ilor"], s) > 0


@pytest.fixture(scope="module")
def grid_pair():
    """JAX's exact fixture model and its grid; the port's model of the
    same configuration on JAX's profile table (float64, CPU)."""
    cfg = grid_config()
    with shared_jax_tables():
        jm = JModel(cfg)
    m = TransitModel(port_config(cfg), dtype=torch.float64, device="cpu",
                     table=ProfileTable(**dataclasses.asdict(jm.table)))
    return jm, jgrid.build_opacity_grid(jm), m


@pytest.fixture(scope="module")
def built(grid_pair):
    return grid.build_opacity_grid(grid_pair[2])


def test_exact_build_equals_jax(grid_pair, built):
    _, want, _ = grid_pair
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
def test_exact_build_chunks_agree(grid_pair, built, cell_batch, tmp_path):
    path = tmp_path / "g.bin"
    og = grid.build_opacity_grid(grid_pair[2], str(path),
                                 cell_batch=cell_batch)
    np.testing.assert_array_equal(og.grid, built.grid)
    back = grid.read_opacity_grid(str(path))
    np.testing.assert_array_equal(back.grid, built.grid)
    np.testing.assert_array_equal(back.molID, built.molID)


def test_exact_build_refuses_a_fast_model(grid_pair):
    m = TransitModel(port_config(grid_config()), mode="fast",
                     dtype=torch.float64, device="cpu")
    with pytest.raises(ValueError, match="exact-mode"):
        grid.build_opacity_grid(m)


def test_permol_scatter_with_one_molecule_is_the_collapsed_one(grid_pair):
    """The plain per-molecule scatter with nm = 1 (every tile on row 0)
    on the group tables of the file atmosphere equals the collapsed
    scatter bit for bit; the tile molecules are checked."""
    m = grid_pair[2]
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
