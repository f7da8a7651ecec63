"""Exact mode's layer function of the port (opacities/lbl.py
layer_extinction, all layers at once) against transit_tpu's
lbl.layer_extinction (per layer under lax.map, as its model runs it),
float64, fed identical state (convert.exact_state_from_numpy of the JAX
model's plan, table and device arrays) on the conformance fixture:
within 1e-12 of each layer's max at the file's temperatures and 200 K
above and below, at the file's ethresh and at one that drops more
groups (both drop some); the Doppler-index forward fill takes each of
its branches.  The plain
scatter is the same whatever its chunk size.  The gradient of sum(w*ext)
in T, the densities and Z: tests/test_torch_exact_layer_grad.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_conformance import make_config
from transit_tpu.model import TransitModel as JModel
from transit_tpu.opacities import lbl as jlbl
from transit_tpu_torch.convert import exact_state_from_numpy
from transit_tpu_torch.numerics.search import nearest_index_torch
from transit_tpu_torch.opacities import lbl
from transit_tpu_torch.opacities.fast import _layer_widths

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
