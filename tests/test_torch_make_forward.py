"""The port's ``TransitModel.make_forward`` against transit_tpu's
(tests/test_fast_and_forward.py:361-375), float64 on the CPU, on the
conformance fixture (tests/test_conformance.make_config): here fast mode
on the unbanded plan; bands=4, transit with hydrostatic radii and the
batched call are in tests/test_torch_make_forward_banded.py, _transit.py
and _batch.py (one JAX model a file: JAX compiles each model's step and
its gradient, ~5-12 s), exact mode in tests/test_torch_exact_grad.py
(beside the exact gradients on the same grid's JAX profile table).

On a CPU model make_forward is the eager ``forward`` bound to
``device_tree()``: its spectrum equals the port's ``forward`` and JAX's
``make_forward()`` within rtol 1e-12, its gradient in T and q
``jax.grad`` over JAX's ``make_forward()`` within 1e-9 of the max, and
the settings read as Python values are fixed when make_forward() is
called.  The CUDA graphs are held to the eager step in
tests/test_torch_cuda.py and chip_smoke.py's ``graph_*`` phases."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tests.test_conformance import make_config
from tests.test_torch_common import port_config
from transit_tpu.model import TransitModel as JModel
from transit_tpu_torch.model import TransitModel
from transit_tpu_torch.opacities.voigt import ProfileTable

torch.set_num_threads(1)

RTOL = 1e-12
GRAD_TOL = 1e-9


def profile(m, seed: int = 5):
    """A perturbed file atmosphere, numpy from a seed."""
    rng = np.random.default_rng(seed)
    T = m.atm.temp + 40.0 + 10.0 * rng.standard_normal(m.atm.nlayers)
    q = m.atm.q * (1.0 + 0.1 * rng.uniform(-1, 1, m.atm.q.shape))
    return T, q


def make_forward_matches_jax(cfg, jax_table: bool = False, **kw):
    """Both packages' models of ``cfg`` (float64): the port's
    make_forward() against its forward and JAX's make_forward() at a
    perturbed profile (rtol RTOL), its gradient of the spectrum's sum in
    T and q against jax.grad over JAX's make_forward() (its VJP with a
    cotangent of ones; GRAD_TOL of the max); returns the port's
    model.  ``jax_table``: the port's exact model takes JAX's profile
    table (equal to its own within 1 ulp; tests/test_torch_exact_voigt.py)
    instead of building it."""
    jm = JModel(cfg, **kw)
    if jax_table:
        kw["table"] = ProfileTable(**dataclasses.asdict(jm.table))
    tm = TransitModel(port_config(cfg), dtype=torch.float64, device="cpu",
                      **kw)
    T0, q0 = profile(tm)
    # One JAX program for the value and one for its transpose: the
    # spectrum of JAX's make_forward() and jax.grad of its sum.
    want, vjp = jax.vjp(jm.make_forward(), jnp.asarray(T0), jnp.asarray(q0))
    gwant = vjp(jnp.ones_like(want))
    want = np.asarray(want)
    fwd = tm.make_forward()
    T = torch.tensor(T0, requires_grad=True)
    q = torch.tensor(q0, requires_grad=True)
    got = fwd(T, q)
    np.testing.assert_allclose(got.detach().numpy(),
                               tm.forward(T0, q0).numpy(), rtol=RTOL)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL)
    for a, b in zip(torch.autograd.grad(got.sum(), (T, q)), gwant):
        b = np.asarray(b)
        assert a.shape == b.shape and np.abs(b).max() > 0
        assert float(np.abs(a.numpy() - b).max()) <= GRAD_TOL * np.abs(
            b).max()
    return tm


def test_make_forward_matches_forward_and_jax():
    tm = make_forward_matches_jax(make_config("eclipse", 1e30), mode="fast")
    assert tm.fplan is not None and tm.bplan is None


def test_make_forward_fixes_the_settings_at_the_call():
    """set_cloudtop, set_scattering and set_radius after make_forward()
    leave its callable as it was; a new make_forward() takes them, and
    equals the eager forward with the new settings; the model's own
    settings are restored after each call."""
    cfg = make_config("eclipse", 1e30)
    cfg.cloudtop = -1.0
    m = TransitModel(port_config(cfg), mode="fast", dtype=torch.float64,
                     device="cpu")
    T0, q0 = profile(m)
    old = m.make_forward()
    before = m.forward(T0, q0)
    m.set_cloudtop(-3.0)
    m.set_scattering(1.5)
    m.set_radius(91000.0)
    after = m.forward(T0, q0)
    assert float((after - before).abs().max()) > 1e-3 * float(
        before.abs().max())
    assert torch.equal(old(T0, q0), before)
    assert torch.equal(m.make_forward()(T0, q0), after)
    assert (m._cloud.cloudtop, m._scatter_logext, m.cfg.refradius) == (
        -3.0, 1.5, 91000.0)
