"""The batched call of the port's ``make_forward`` (T (B, nl), q (B,
nmol, nl): forward_batch, the counterpart of jax.vmap over JAX's jitted
step) against jax.vmap of transit_tpu's ``make_forward()``, float64 on
the CPU, on tests/test_retrieval.py's model (the conformance fixture,
fast mode, bands=4): rtol 1e-12, and equal to the port's single calls
within rtol 1e-12; the batched value and gradient of
tests/test_retrieval.py:101-114 (retrieval.batched_value_and_grad over
the callable): shapes (4,) and (4, nl), zero loss at the true profile,
finite gradients, nonzero off it."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tests.test_conformance import make_config
from tests.test_torch_common import port_config
from tests.test_torch_make_forward import RTOL, profile
from transit_tpu.model import TransitModel as JModel
from transit_tpu_torch.model import TransitModel
from transit_tpu_torch.retrieval import batched_value_and_grad

torch.set_num_threads(1)


def test_batched_make_forward_matches_jax_vmap():
    cfg = make_config("eclipse", 1e30)
    jm = JModel(cfg, mode="fast", bands=4)
    tm = TransitModel(port_config(cfg), mode="fast", dtype=torch.float64,
                      device="cpu", bands=4)
    members = [profile(tm, seed) for seed in range(3)]
    Tb = np.stack([T for T, _ in members])
    qb = np.stack([q for _, q in members])
    want = np.asarray(jax.vmap(jm.make_forward())(jnp.asarray(Tb),
                                                  jnp.asarray(qb)))
    fwd = tm.make_forward()
    got = fwd(torch.tensor(Tb), torch.tensor(qb)).numpy()
    assert got.shape == (3, tm.wns.n)
    np.testing.assert_allclose(got, want, rtol=RTOL)
    for i, (T, q) in enumerate(members):
        np.testing.assert_allclose(got[i], fwd(T, q).numpy(), rtol=RTOL)

    # tests/test_retrieval.py:101-114 through the callable:
    t0 = torch.tensor(tm.atm.temp)
    q = torch.tensor(tm.atm.q)
    target = fwd(t0, q)

    def loss(t):
        return torch.mean((fwd(t, q.expand(t.shape[:1] + q.shape)) -
                           target) ** 2, dim=-1)

    batch = torch.stack([t0 * (1.0 + 0.02 * i) for i in range(4)])
    vals, grads = batched_value_and_grad(loss)(batch)
    assert vals.shape == (4,) and grads.shape == batch.shape
    assert float(vals[0]) < 1e-12
    assert torch.isfinite(grads).all() and float(grads[1].abs().max()) > 0
