"""TransitModel.forward_batch of the port, float64 on the eclipse fixture,
B = 3 profiles made with numpy from a seed: against a loop of forward
(rtol 1e-10) and its gradient against the loop's (rtol 1e-6, atol 1e-30,
the bounds of tests/test_fast_and_forward.py's
test_forward_batch_matches_vmap), and against transit_tpu's
forward_batch on the same inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_conformance import make_config
from tests.test_torch_common import port_config
from transit_tpu.model import TransitModel as JModel
from transit_tpu_torch import model as model_module
from transit_tpu_torch.model import TransitModel

torch.set_num_threads(1)

B = 3


def _batch(m):
    rng = np.random.default_rng(21)
    T0, q0 = m.atm.temp, m.atm.q
    Tb = np.stack([T0, T0 * 1.01 + rng.normal(0.0, 5.0, T0.shape),
                   T0 * 0.98])
    qb = np.stack([q0, q0 * (1.0 + 0.1 * rng.uniform(-1, 1, q0.shape)), q0])
    return Tb, qb


@pytest.fixture(scope="module", params=[0, 6], ids=["unbanded", "bands6"])
def model(request):
    return TransitModel(port_config(make_config("eclipse", 1e30)), mode="fast",
                        dtype=torch.float64, device="cpu",
                        bands=request.param)


@pytest.fixture(scope="module")
def batch_and_loop(model):
    """forward_batch's spectra and gradient, and the loop's."""
    Tb, qb = _batch(model)
    T = torch.tensor(Tb, requires_grad=True)
    q = torch.tensor(qb, requires_grad=True)
    spec = model.forward_batch(T, q)
    grads = torch.autograd.grad(spec.sum(), (T, q))
    loop, lgrads = [], []
    for i in range(B):
        t = torch.tensor(Tb[i], requires_grad=True)
        qq = torch.tensor(qb[i], requires_grad=True)
        s = model.forward(t, qq)
        loop.append(s.detach())
        lgrads.append(torch.autograd.grad(s.sum(), (t, qq)))
    return (spec.detach(), grads, torch.stack(loop),
            [torch.stack([g[k] for g in lgrads]) for k in range(2)])


def test_forward_batch_matches_loop(model, batch_and_loop):
    spec, _, loop, _ = batch_and_loop
    assert spec.shape == (B, model.wns.n)
    assert torch.isfinite(spec).all()
    np.testing.assert_allclose(spec.numpy(), loop.numpy(), rtol=1e-10,
                               atol=0)


def test_forward_batch_gradient_matches_loop(batch_and_loop):
    _, grads, _, lgrads = batch_and_loop
    for a, b in zip(grads, lgrads):
        assert a.shape == b.shape and float(a.abs().max()) > 0
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-30)


def test_forward_batch_matches_jax(model, batch_and_loop):
    """The same inputs through transit_tpu's forward_batch (jitted)."""
    jm = JModel(make_config("eclipse", 1e30), mode="fast",
                bands=6 if model.bplan is not None else 0)
    Tb, qb = _batch(model)
    ref = np.asarray(jax.jit(jm.forward_batch)(jnp.asarray(Tb),
                                               jnp.asarray(qb)))
    got = batch_and_loop[0].numpy()
    assert float(np.abs(got - ref).max()) <= 1e-10 * np.abs(ref).max()


def test_batched_view_shares_the_plan(model, monkeypatch):
    """The batched view (cached per B) reuses the model's tile plans, and
    the batch's layer bound is checked against the kernels' int32
    indices: a batch past it is split into sub-batches below it
    (tests/test_torch_forward_batch_split.py runs them), and a model
    whose single member passes it raises."""
    if model.bplan is None:
        assert model.forward_batch(*_batch(model)).shape[0] == B
    else:
        view, index = model._batched_bplan(B)
        assert model._batched_bplan(B)[0] is view
        assert view.plans is model.bplan.plans
        assert [b - a for a, b in view.slices] == [
            B * (b - a) for a, b in model.bplan.slices]
        assert sorted(view.perm.tolist()) == list(range(B * 20))
        assert index is None           # the CPU model has no kernel index
    big = 2 ** 31 // (20 * model.wns.n) + 1
    splits = model.batch_splits(big)
    assert len(splits) == 2 and splits[0][0] == 0 and splits[-1][1] == big
    assert all(a < b and (b - a) * 20 * model.wns.n < 2 ** 31
               for a, b in splits)
    monkeypatch.setattr(model_module, "INDEX_LIMIT", 20 * model.wns.n)
    T = torch.as_tensor(model.atm.temp)[None]
    q = torch.as_tensor(model.atm.q)[None]
    with pytest.raises(ValueError, match="int32"):
        model.forward_batch(T, q)
