"""The gradient of exact mode's layer function (opacities/lbl.py
layer_extinction: autograd through the group tables, the plain VJP of
the profile scatter in g_k) against jax.grad of transit_tpu's
lbl.layer_extinction under lax.map, float64, fed identical state, on the
conformance fixture's 2000-2040 cm-1 (the JAX table builds in half the
time of the whole fixture's): d/d(T, densities, Z) of sum(w * ext), w
random, within 1e-9 of each gradient's max, at the file's temperatures
and 200 K above."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_conformance import make_config
from tests.test_torch_exact_layer import (jax_layers, layer_state,
                                          make_pair, port_layers)

torch.set_num_threads(1)

WNHIGH = 2040.0


@pytest.fixture(scope="module")
def pair():
    cfg = make_config("eclipse", 1e30)
    cfg.wnhigh = WNHIGH
    return make_pair(cfg)


@pytest.mark.parametrize("dT", [0.0, 200.0])
def test_layer_gradient_matches_jax(pair, dT):
    jm, plan, d = pair
    fn = jax_layers(jm, 1e-8)
    args = layer_state(jm, dT)
    w = np.random.default_rng(11).standard_normal((jm.atm.nlayers,
                                                   jm.wns.n))
    ref = jax.jit(jax.grad(lambda t, dd, z: jnp.sum(fn(t, dd, z) * w),
                           argnums=(0, 1, 2)))(
                               *(jnp.asarray(a) for a in args[:3]))
    leaves = [torch.tensor(a, requires_grad=True) for a in args[:3]]
    ext = port_layers(jm, plan, d, (*leaves, *args[3:]), 1e-8)
    got = torch.autograd.grad((ext * torch.as_tensor(w)).sum(), leaves)
    for name, a, b in zip(("T", "densities", "Z"), got, ref):
        b = np.asarray(b)
        assert a.shape == b.shape and np.abs(b).max() > 0, name
        assert (float(np.abs(a.numpy() - b).max()) <=
                1e-9 * np.abs(b).max()), name
