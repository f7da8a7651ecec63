"""The port's exact-mode model through its entry points, on the
conformance fixture (one profile table for the module): ``forward``
equals ``compute`` at the file's atmosphere (rtol 1e-12, as
tests/test_fast_and_forward.py:149-155 holds JAX), ``run_transit``
equals ``forward``, ``forward_batch`` raises with JAX's message,
``torch.func.vmap(m.forward)`` equals a loop of ``forward`` (values and
gradients), float32 against float64, the default mode is JAX's, and
a profile table of another configuration is refused.
The gradient against jax.grad: tests/test_torch_exact_grad*.py."""

import dataclasses
import inspect

import numpy as np
import pytest
import torch

from tests.test_conformance import make_config
from transit_tpu.model import TransitModel as JModel
from transit_tpu_torch.config import TransitConfig
from transit_tpu_torch.model import TransitModel

torch.set_num_threads(1)

# float32 against float64 exact spectra: max |a/b - 1|, float32 rounding
# of the extinction sums and of tau's products (3.4e-7 on the eclipse
# fixture when this bound was set; 30x margin).
F32_TOL = 1e-5


def port(cfg):
    return TransitConfig(**dataclasses.asdict(cfg))


@pytest.fixture(scope="module")
def m64():
    return TransitModel(port(make_config("eclipse", 1e30)),
                        dtype=torch.float64, device="cpu")


def profiles(m, n=3, seed=5):
    """n (T, q) profiles near the file's, made with numpy from a seed."""
    rng = np.random.default_rng(seed)
    T0, q0 = m.atm.temp, m.atm.q
    T = np.stack([T0 * (1.0 + 0.02 * rng.uniform(-1, 1)) +
                  rng.normal(0.0, 3.0, T0.shape) for _ in range(n)])
    q = np.stack([q0 * (1.0 + 0.05 * rng.uniform(-1, 1, q0.shape))
                  for _ in range(n)])
    return T, q


def test_default_mode_is_jax_default(m64):
    port_default = inspect.signature(TransitModel).parameters["mode"]
    jax_default = inspect.signature(JModel).parameters["mode"]
    assert port_default.default == jax_default.default == "exact"
    assert m64.mode == "exact" and m64.plan is not None
    assert m64.device_tree() is m64.dev


def test_forward_matches_compute(m64):
    spec0 = m64.compute().spectrum.numpy()
    spec1 = m64.forward(m64.atm.temp, m64.atm.q).numpy()
    np.testing.assert_allclose(spec1, spec0, rtol=1e-12)


def test_run_transit_matches_forward(m64):
    T, q = profiles(m64, 1)
    flat = np.concatenate([T[0], q[0].ravel()])
    np.testing.assert_array_equal(m64.run_transit(flat).numpy(),
                                  m64.forward(T[0], q[0]).numpy())


def test_forward_batch_raises(m64):
    T, q = profiles(m64, 2)
    with pytest.raises(ValueError, match="mode='fast'"):
        m64.forward_batch(torch.as_tensor(T), torch.as_tensor(q))


def test_vmap_forward_equals_loop(m64):
    """torch.func.vmap(m.forward) over 3 profiles against 3 forward calls,
    and the gradient of its sum in T and q against theirs."""
    T, q = profiles(m64)
    Tb = torch.tensor(T, requires_grad=True)
    qb = torch.tensor(q, requires_grad=True)
    spec = torch.func.vmap(m64.forward)(Tb, qb)
    gT, gq = torch.autograd.grad(spec.sum(), (Tb, qb))
    for i in range(T.shape[0]):
        t = torch.tensor(T[i], requires_grad=True)
        qq = torch.tensor(q[i], requires_grad=True)
        s = m64.forward(t, qq)
        a, b = torch.autograd.grad(s.sum(), (t, qq))
        np.testing.assert_allclose(spec[i].detach().numpy(),
                                   s.detach().numpy(), rtol=1e-12)
        for x, y in ((gT[i], a), (gq[i], b)):
            assert float((x - y).abs().max()) <= 1e-10 * float(y.abs().max())


def test_float32_against_float64(m64):
    m32 = TransitModel(port(make_config("eclipse", 1e30)),
                       dtype=torch.float32, device="cpu", table=m64.table)
    a = m32.compute().spectrum.double().numpy()
    b = m64.compute().spectrum.numpy()
    assert a.dtype == b.dtype and a.shape == b.shape
    assert float(np.max(np.abs(a / b - 1.0))) < F32_TOL


@pytest.mark.parametrize("field, value", [("nwidth", 10.0), ("ndop", 14),
                                          ("dmin", 2e-3), ("wnosamp", 1)])
def test_table_of_another_configuration_raises(m64, field, value):
    cfg = port(make_config("eclipse", 1e30))
    setattr(cfg, field, value)
    with pytest.raises(ValueError, match="profile table"):
        TransitModel(cfg, dtype=torch.float64, device="cpu", table=m64.table)
