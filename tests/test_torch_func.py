"""torch.func over the port's fast-mode ``forward`` (the line
extinction's autograd Functions have setup_context and vmap rules that
fold a batch into pseudo-layers, as forward_batch does), float64 on the
eclipse fixture, bands=6 and unbanded: ``torch.func.vmap(m.forward)``
equals ``forward_batch``, values and gradients to 1e-10 of their max,
the gradients both through autograd of the vmapped forward and through
``vmap(grad(...))``; and ``retrieval.hmc_sample`` with its default
``vg_fn`` (vmap of grad_and_value of a per-chain log posterior) runs
through the model."""

import numpy as np
import pytest
import torch

from tests.test_conformance import make_config
from tests.test_torch_common import port_config
from transit_tpu_torch.model import TransitModel
from transit_tpu_torch.retrieval import gaussian_logprob, hmc_sample

torch.set_num_threads(1)

B = 3
TOL = 1e-10


@pytest.fixture(scope="module", params=[6, 0], ids=["bands6", "unbanded"])
def model(request):
    return TransitModel(port_config(make_config("eclipse", 1e30)),
                        mode="fast", dtype=torch.float64, device="cpu",
                        bands=request.param)


def _batch(m):
    rng = np.random.default_rng(8)
    T0, q0 = m.atm.temp, m.atm.q
    T = np.stack([T0 * (1.0 + 0.01 * rng.uniform(-1, 1)) +
                  rng.normal(0.0, 4.0, T0.shape) for _ in range(B)])
    q = np.stack([q0 * (1.0 + 0.05 * rng.uniform(-1, 1, q0.shape))
                  for _ in range(B)])
    return T, q


def _close(a, b):
    assert a.shape == b.shape
    assert float((a - b).abs().max()) <= TOL * float(b.abs().max())


def test_vmap_forward_equals_forward_batch(model):
    T, q = _batch(model)
    Tv, qv = (torch.tensor(a, requires_grad=True) for a in (T, q))
    Tb, qb = (torch.tensor(a, requires_grad=True) for a in (T, q))
    got = torch.func.vmap(model.forward)(Tv, qv)
    want = model.forward_batch(Tb, qb)
    _close(got.detach(), want.detach())
    w = torch.as_tensor(np.random.default_rng(2).standard_normal(
        tuple(want.shape)))
    for a, b in zip(torch.autograd.grad((got * w).sum(), (Tv, qv)),
                    torch.autograd.grad((want * w).sum(), (Tb, qb))):
        _close(a, b)


def test_vmap_of_grad_equals_forward_batch(model):
    T, q = _batch(model)
    g = torch.func.vmap(torch.func.grad(
        lambda t, qq: model.forward(t, qq).sum(), argnums=(0, 1)))(
            torch.as_tensor(T), torch.as_tensor(q))
    Tb, qb = (torch.tensor(a, requires_grad=True) for a in (T, q))
    want = torch.autograd.grad(model.forward_batch(Tb, qb).sum(), (Tb, qb))
    for a, b in zip(g, want):
        _close(a, b)


def test_hmc_default_vg_fn_through_model():
    """hmc_sample(logprob, ...) with vg_fn None: vmap(grad_and_value) of
    a log posterior over a per-profile temperature scale, through the
    banded model; finite samples, some accepted (4 chains started near
    the truth, 1% noise)."""
    model = TransitModel(port_config(make_config("eclipse", 1e30)),
                         mode="fast", dtype=torch.float64, device="cpu",
                         bands=6)
    T0 = torch.as_tensor(model.atm.temp)
    q0 = torch.as_tensor(model.atm.q)
    obs = model.forward(T0, q0).detach()

    def fwd(x):
        return model.forward(T0 * x[0], q0)

    logprob = gaussian_logprob(fwd, obs, 1e-2 * float(obs.abs().mean()),
                               prior_mean=1.0, prior_sigma=0.1)
    gen = torch.Generator().manual_seed(3)
    x0 = 1.0 + 1e-4 * torch.randn((4, 1), generator=gen,
                                  dtype=torch.float64)
    samples, accept, (x, lp) = hmc_sample(logprob, x0, gen, step_size=1e-5,
                                          n_leapfrog=2, n_samples=3)
    assert samples.shape == (3, 4, 1) and bool(torch.isfinite(samples).all())
    assert bool(torch.isfinite(lp).all()) and bool(accept.any())
