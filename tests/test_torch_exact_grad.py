"""Exact mode's gradients against transit_tpu's, float64, on the
conformance fixture's 2000-2040 cm-1 (the JAX table builds in half the
time of the whole fixture's, and once for this file:
test_torch_common.shared_jax_tables):

  * the port's exact ``forward``'s gradient in T and q against jax.grad
    of transit_tpu's exact ``forward`` (jitted), within 1e-9 of each
    gradient's max: eclipse with the file's static radii, and transit
    geometry with hydrostatic radii (tests/test_torch_transit_model.py's
    HYDRO: gsurf 980, refpress 1, refradius 92000; every step rebuilds
    the radii, the path weights and the modulation table);
  * the port's ``make_forward`` in exact mode (the default) against
    transit_tpu's, the port's model on JAX's profile table: rtol 1e-12
    against the port's ``forward`` and JAX's ``make_forward()``, the
    gradient within 1e-9 of the max (tests/test_torch_make_forward.py);
  * the gradient of exact mode's layer function (opacities/lbl.py
    layer_extinction: autograd through the group tables, the plain VJP
    of the profile scatter in g_k) against jax.grad of transit_tpu's
    lbl.layer_extinction under lax.map, fed identical state
    (tests/test_torch_exact_layer.py): d/d(T, densities, Z) of
    sum(w * ext), w random, within 1e-9 of each gradient's max, at the
    file's temperatures and 200 K above;
  * the same layer function forced into chunks of 3 layers
    (kernel_profile.ChunkedExtinction: its backward recomputes a chunk
    at a time) against the same JAX program's lax.map forward (1e-12 of
    each layer's max) and gradient (1e-9 of each gradient's max)."""

import functools

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_conformance import make_config
from tests.test_torch_common import shared_jax_tables
from tests.test_torch_exact_layer import (jax_layers, layer_state,
                                          make_pair, port_layers)
from tests.test_torch_make_forward import make_forward_matches_jax
from tests.test_torch_transit_model import HYDRO
from transit_tpu.model import TransitModel as JModel
from transit_tpu_torch.config import TransitConfig
from transit_tpu_torch.model import TransitModel

torch.set_num_threads(1)

WNHIGH = 2040.0


def gradient_matches_jax(cfg):
    """d sum(forward) / d(T, q) of both packages' exact models of cfg
    (cut at WNHIGH) at the file's atmosphere: max|a - b| <= 1e-9
    max|b|."""
    cfg.wnhigh = WNHIGH
    with shared_jax_tables():
        jm = JModel(cfg)
    assert jm.mode == "exact"
    ref = jax.jit(jax.grad(lambda t, q: jnp.sum(jm.forward(t, q)),
                           argnums=(0, 1)))(jnp.asarray(jm.atm.temp),
                                            jnp.asarray(jm.atm.q))
    m = TransitModel(TransitConfig(**dataclasses.asdict(cfg)),
                     dtype=torch.float64, device="cpu")
    T = torch.tensor(m.atm.temp, requires_grad=True)
    q = torch.tensor(m.atm.q, requires_grad=True)
    got = torch.autograd.grad(m.forward(T, q).sum(), (T, q))
    for a, b in zip(got, ref):
        b = np.asarray(b)
        assert a.shape == b.shape and np.abs(b).max() > 0
        assert float(np.abs(a.numpy() - b).max()) <= 1e-9 * np.abs(b).max()


def test_eclipse_gradient_matches_jax():
    gradient_matches_jax(make_config("eclipse", 1e30))


def test_transit_hydrostatic_gradient_matches_jax():
    cfg = make_config("transit", 1e30)
    for k, v in HYDRO.items():
        setattr(cfg, k, v)
    gradient_matches_jax(cfg)


def test_exact_make_forward_matches_forward_and_jax():
    cfg = make_config("eclipse", 1e30)
    cfg.wnhigh = WNHIGH
    with shared_jax_tables():
        tm = make_forward_matches_jax(cfg, jax_table=True)
    assert tm.mode == "exact" and tm.plan is not None


@pytest.fixture(scope="module")
def pair():
    cfg = make_config("eclipse", 1e30)
    cfg.wnhigh = WNHIGH
    return make_pair(cfg)


@functools.lru_cache(maxsize=None)
def jax_layer_value_and_grad(jm):
    """One jitted JAX program: the layers' extinction under lax.map
    (jax_layers) and the gradient of sum(w * ext) in (T, densities, Z)."""
    fn = jax_layers(jm, 1e-8)

    def loss(t, dd, z, w):
        ext = fn(t, dd, z)
        return jnp.sum(ext * w), ext

    return jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2),
                                      has_aux=True))


def layer_case(pair, dT, **kw):
    """The port's layer function (``kw``: lbl.layer_extinction's) and its
    gradient of sum(w * ext) against JAX's at the file's temperatures +
    dT, w random: the gradients within 1e-9 of each one's max; returns
    (the port's extinction, JAX's)."""
    jm, plan, d = pair
    args = layer_state(jm, dT)
    w = np.random.default_rng(11).standard_normal((jm.atm.nlayers,
                                                   jm.wns.n))
    (_, ref_ext), ref = jax_layer_value_and_grad(jm)(
        *(jnp.asarray(a) for a in args[:3]), jnp.asarray(w))
    leaves = [torch.tensor(a, requires_grad=True) for a in args[:3]]
    ext = port_layers(jm, plan, d, (*leaves, *args[3:]), 1e-8, **kw)
    got = torch.autograd.grad((ext * torch.as_tensor(w)).sum(), leaves)
    for name, a, b in zip(("T", "densities", "Z"), got, ref):
        b = np.asarray(b)
        assert a.shape == b.shape and np.abs(b).max() > 0, name
        assert (float(np.abs(a.numpy() - b).max()) <=
                1e-9 * np.abs(b).max()), name
    return ext.detach().numpy(), np.asarray(ref_ext)


@pytest.mark.parametrize("dT", [0.0, 200.0])
def test_layer_gradient_matches_jax(pair, dT):
    layer_case(pair, dT)


def test_chunked_layers_match_jax(pair):
    jm = pair[0]
    assert jm.atm.nlayers % 3 != 0      # the last chunk is short
    got, ref = layer_case(pair, 200.0, rows=3)
    scale = np.abs(ref).max(axis=1, keepdims=True)
    assert got.shape == ref.shape and np.all(scale > 0)
    assert float(np.max(np.abs(got - ref) / scale)) <= 1e-12
