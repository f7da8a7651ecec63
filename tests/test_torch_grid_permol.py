"""Exact mode's per-molecule layer function (lbl.layer_extinction with
``nm``: kmax per output molecule, no density factor, one row per
molecule) against transit_tpu's lbl.layer_extinction(permol=True),
float64, on a hot-Jupiter slice with all four molecules (H2O, CO, CO2,
CH4: benchmarks/data/hj, 3000-3040 cm-1, oversampled 54 times, a 15 x 15
profile table): nine (layer, temperature) cells, at the file's ethresh
and at one that cuts more, each molecule within 1e-12 of its own max;
the cut bites and the per-molecule kmax keeps groups the collapsed one
cuts.  And the exact grid build of the slice (100 layers x 3
temperatures x 4 molecules) against transit_tpu's build_opacity_grid."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_common import hotjupiter_config, port_config
from transit_tpu.model import TransitModel as JModel
from transit_tpu.opacities import grid as jgrid
from transit_tpu.opacities import lbl as jlbl
from transit_tpu_torch.constants import AMU, KB
from transit_tpu_torch.convert import exact_state_from_numpy
from transit_tpu_torch.model import TransitModel
from transit_tpu_torch.numerics.spline import splinterp_np
from transit_tpu_torch.opacities import grid, lbl
from transit_tpu_torch.opacities.voigt import ProfileTable

torch.set_num_threads(1)

ETHRESH = (1e-8, 1e-3)
LAYERS = (0, 40, 99)
TEMPS = (700.0, 1500.0, 2500.0)


def slice_config():
    cfg = hotjupiter_config()
    cfg.wnlow, cfg.wnhigh = 3000.0, 3040.0
    cfg.wnosamp = 54
    cfg.ndop = cfg.nlor = 15
    cfg.tlow, cfg.thigh, cfg.tempdelt = 1000.0, 2000.0, 500.0
    return cfg


@pytest.fixture(scope="module")
def pair():
    """JAX's exact model of the slice, and the port's (plan, device
    arrays) made from its state."""
    jm = JModel(slice_config())
    plan, _, d = exact_state_from_numpy(
        dataclasses.asdict(jm.plan), dataclasses.asdict(jm.table),
        {k: np.asarray(v) for k, v in jm.dev.items()},
        dtype=torch.float64, device="cpu")
    assert jm.iso.nmol_out == 4
    return jm, plan, d


def cells(jm):
    """(T, densities (cells, nmol), Z (cells, niso)) of LAYERS x TEMPS,
    the densities of stateeqnford at the cell's temperature."""
    atm = jm.atm
    rr = np.repeat(LAYERS, len(TEMPS))
    tt = np.tile(np.asarray(TEMPS), len(LAYERS))
    dd = np.stack([AMU * atm.q[:, r] * atm.press[r] * atm.pfct / KB / T *
                   (atm.mm[r] if atm.by_mass else np.asarray(jm.mol.mass))
                   for r, T in zip(rr, tt)])
    zz = np.stack([[splinterp_np(t, z, np.array([T]))[0] for t, z in jm._pf]
                   for T in tt])
    return tt, dd, zz


@pytest.mark.parametrize("ethresh", ETHRESH)
def test_permol_layers_equal_jax(pair, ethresh):
    jm, plan, d = pair
    tt, dd, zz = cells(jm)
    molm, molr = np.asarray(jm.mol.mass), np.asarray(jm.mol.radius)
    wn0 = float(jm.wns.v[0])
    fn = jax.jit(jax.vmap(lambda t, dn, z: jlbl.layer_extinction(
        jm.plan, jm.iso, jm.table, jm.dev, t, dn, z, jnp.asarray(molm),
        jnp.asarray(molr), wn0, ethresh=ethresh, permol=True)))
    want = np.asarray(fn(jnp.asarray(tt), jnp.asarray(dd), jnp.asarray(zz)))
    args = tuple(torch.as_tensor(a) for a in (tt, dd.T, zz.T, molm, molr))
    got = lbl.layer_extinction(plan, d, *args, wn0=wn0, ethresh=ethresh,
                               use_kernel=False, nm=4).numpy()
    assert got.shape == want.shape == (len(tt), 4, jm.wns.n)
    for m in range(4):
        scale = np.abs(want[:, m]).max()
        assert scale > 0
        assert np.abs(got[:, m] - want[:, m]).max() <= 1e-12 * scale, m

    # The cut bites, and per molecule it keeps groups the collapsed cut
    # (against the max over all species) drops:
    grp = lbl.layer_groups(d, *args, wn0=wn0, ethresh=ethresh, nm=4)
    one = lbl.layer_groups(d, *args, wn0=wn0, ethresh=ethresh)
    live = d["g_inrange"].expand_as(grp["keep"])
    assert int(grp["keep"].sum()) < int(live.sum())
    assert bool((grp["keep"] & ~one["keep"]).any())
    assert not bool((one["keep"] & ~grp["keep"]).any())


def test_exact_grid_of_the_slice_equals_jax(pair):
    jm, _, _ = pair
    want = jgrid.build_opacity_grid(jm)
    m = TransitModel(port_config(slice_config()), dtype=torch.float64,
                     device="cpu",
                     table=ProfileTable(**dataclasses.asdict(jm.table)))
    got = grid.build_opacity_grid(m, cell_batch=64)
    assert got.grid.shape == want.grid.shape == (100, 3, 4, jm.wns.n)
    np.testing.assert_array_equal(got.molID, want.molID)
    for mol in range(4):
        scale = np.abs(want.grid[:, :, mol]).max()
        assert scale > 0
        assert np.abs(got.grid[:, :, mol] -
                      want.grid[:, :, mol]).max() <= 1e-12 * scale
