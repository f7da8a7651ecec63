"""The gradient through the port's sharded step (4 shards, each through
``step.local``, assembled) against the port's single model's gradient and
against ``jax.grad`` of JAX's sharded step on a 4-device mesh, float64,
at JAX's tolerances (tests/test_sharded.py:56-80)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tests.test_conformance import make_config
from tests.test_torch_sharded import NSHARD, _mesh, _port
from transit_tpu.model import TransitModel as JModel
from transit_tpu.parallel import sharded as jsharded
from transit_tpu_torch.parallel import sharded

torch.set_num_threads(1)


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-7,
                               atol=np.abs(want).max() * 1e-9)


def check_grad(bands: int):
    """d vdot(w, spectrum) / d(T, q)."""
    jc = make_config("eclipse", 1e30)
    m = _port(jc, bands)
    step = sharded.make_sharded_forward(m, nshard=NSHARD)
    w = torch.linspace(0.5, 2.0, m.wns.n, dtype=torch.float64)

    def grad(f):
        T = torch.as_tensor(m.atm.temp).requires_grad_()
        q = torch.as_tensor(m.atm.q).requires_grad_()
        return [g.numpy() for g in
                torch.autograd.grad(torch.dot(w, f(T, q)), (T, q))]

    got = grad(lambda T, q: step.assemble(
        [step.local(s, T, q) for s in range(NSHARD)]))
    for a, b in zip(got, grad(m.forward)):
        _close(a, b)
    jm = JModel(jc, mode="fast", bands=bands)
    jstep = jsharded.make_sharded_forward(jm, _mesh())
    wj = jnp.linspace(0.5, 2.0, jm.wns.n)
    want = jax.jit(jax.grad(lambda t, qq: jnp.vdot(wj, jstep(t, qq)),
                            argnums=(0, 1)))(jnp.asarray(jm.atm.temp),
                                             jnp.asarray(jm.atm.q))
    for a, b in zip(got, want):
        _close(a, np.asarray(b))


def test_sharded_grad_banded_matches_single_and_jax():
    """bands=4 (the unbanded plan: tests/test_torch_sharded_grad_0.py)."""
    check_grad(4)
