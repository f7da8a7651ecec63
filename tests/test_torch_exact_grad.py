"""The gradient of the port's exact-mode ``forward`` in T and q against
jax.grad of transit_tpu's exact ``forward`` (jitted), float64, on the
conformance fixture's 2000-2040 cm-1 (the JAX table builds in half the
time of the whole fixture's): eclipse with the file's static radii,
within 1e-9 of each gradient's max.  Transit with hydrostatic radii:
tests/test_torch_exact_grad_transit.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tests.test_conformance import make_config
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
