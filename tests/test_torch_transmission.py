"""The port's transmission layer (rt/transmission.py: the modulation
weight tables, modulation with and without ``transparent``,
modulation_m1) against transit_tpu's on the same inputs, made with numpy
from a seed, and the analytic optical depths of
tests/test_analytic_tau.py for the port's numpy and tensor path
weights.

Tolerances: as tests/test_torch_geometry.py (values 1e-12 of max in
float64, gradients 1e-9 of max |jax.grad|); the analytic cases keep
test_analytic_tau.py's bounds."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.integrate import quad

from tests.test_torch_geometry import VAL_TOL, check_fn, radii, rel, t64
from transit_tpu.rt import transmission as jtrans
from transit_tpu_torch.rt import geometry as tgeom
from transit_tpu_torch.rt import tau as ttau
from transit_tpu_torch.rt import transmission as ttrans

torch.set_num_threads(1)


def test_modulation_weight_table_matches_jax():
    ipv = np.sort(np.random.default_rng(4).uniform(1.0, 2.0, 13))
    check_fn(jtrans.modulation_weight_table_jnp,
             ttrans.modulation_weight_table_torch, (ipv,))


def _tau_case(nwn=40, seed=21):
    """tau (nwn, nip) over descending impact parameters (rows grow
    downwards), last from the port's last_index at toomuch 5."""
    rng = np.random.default_rng(seed)
    rad = radii()
    nip = rad.shape[0]
    tau = np.cumsum(rng.uniform(0.0, 0.6, (nwn, nip)), axis=1) * \
        rng.uniform(0.2, 1.5, (nwn, 1))
    tau[:, 0] = 0.0
    toomuch = 5.0
    last = ttau.last_index(torch.as_tensor(tau), toomuch).numpy()
    assert 0 < np.sum(last < nip - 1) < nwn       # both kinds of rows
    return tau, last, rad[::-1].copy(), toomuch


@pytest.mark.parametrize("transparent", [False, True])
def test_modulation_matches_jax(transparent):
    """modulation with the table built from the (traced) impact
    parameters, as under hydrostatic radii: values and gradients in tau
    and the impact parameters."""
    tau, last, ipv, toomuch = _tau_case()
    srad = 1.125 * 6.957e10
    check_fn(lambda t, ip: jtrans.modulation(
        t, jnp.asarray(last), ip, 1e5, srad, toomuch,
        transparent=transparent),
        lambda t, ip: ttrans.modulation(
            t, torch.as_tensor(last), ip, 1e5, srad, toomuch,
            transparent=transparent), (tau, ipv))


def test_modulation_gradient_finite_beyond_last():
    """Beyond tau.last, tau can be negative (the tangent-point parabola
    gives negative path weights): modulation's value and gradient do not
    depend on those cells, and the gradient stays finite where exp(-tau)
    overflows (-200 here, float32)."""
    tau, last, ipv, toomuch = _tau_case(seed=24)
    beyond = np.arange(tau.shape[1])[None, :] > last[:, None]
    assert beyond.any()
    grads = []
    for fill in (None, -200.0):
        t = torch.tensor(np.where(beyond, fill, tau) if fill else tau,
                         dtype=torch.float32, requires_grad=True)
        spec = ttrans.modulation(t, torch.as_tensor(last),
                                 torch.tensor(ipv, dtype=torch.float32),
                                 1e5, 7e10, toomuch)
        grads.append((spec.detach(), torch.autograd.grad(spec.sum(), t)[0]))
    (s0, g0), (s1, g1) = grads
    assert torch.equal(s0, s1) and torch.equal(g0, g1)
    assert bool(torch.isfinite(g1).all()) and not bool(g1[beyond].any())


def test_modulation_with_a_given_table_matches_jax():
    """The static path: Wmod from the numpy table."""
    tau, last, ipv, toomuch = _tau_case(seed=22)
    Wmod = ttrans.modulation_weight_table(ipv[::-1] * 1e5)
    np.testing.assert_array_equal(
        Wmod, jtrans.modulation_weight_table(ipv[::-1] * 1e5))
    got = ttrans.modulation(t64(tau), torch.as_tensor(last), t64(ipv), 1e5,
                            7e10, toomuch, Wmod=t64(Wmod)).numpy()
    want = jtrans.modulation(jnp.asarray(tau), jnp.asarray(last),
                             jnp.asarray(ipv), 1e5, 7e10, toomuch,
                             Wmod=jnp.asarray(Wmod))
    assert rel(got, want) <= VAL_TOL


def test_modulation_m1_matches_jax():
    tau, last, ipv, toomuch = _tau_case(seed=23)
    got = ttrans.modulation_m1(t64(tau), torch.as_tensor(last), t64(ipv),
                               1e5, 7e10, toomuch).numpy()
    want = np.asarray(jtrans.modulation_m1(
        jnp.asarray(tau), jnp.asarray(last), jnp.asarray(ipv), 1e5, 7e10,
        toomuch))
    assert np.any(want == -1.0) and np.any(want > 0)
    np.testing.assert_array_equal(got == -1.0, want == -1.0)
    assert rel(got, want) <= VAL_TOL
    reached = want > 0
    check_fn(lambda t, ip: jtrans.modulation_m1(
        t, jnp.asarray(last), ip, 1e5, 7e10, toomuch)[reached],
        lambda t, ip: ttrans.modulation_m1(
            t, torch.as_tensor(last), ip, 1e5, 7e10, toomuch)[reached],
        (tau, ipv))


# --- tests/test_analytic_tau.py, for the numpy and the tensor weights ---

def _transit_W(source, rad):
    if source == "numpy":
        return ttau.transit_weights(rad, rad[::-1].copy())
    return tgeom.transit_weights_torch(t64(rad)).numpy()


def _eclipse_W(source, rad):
    if source == "numpy":
        return ttau.eclipse_weights(rad)
    return tgeom.eclipse_weights_torch(t64(rad)).numpy()


@pytest.mark.parametrize("source", ["numpy", "torch"])
def test_transit_tau_constant_extinction(source):
    # tau(b) = 2 * e0 * sqrt(R^2 - b^2) for constant extinction:
    n = 400
    rad = np.linspace(70000.0, 80000.0, n)
    W = _transit_W(source, rad)
    e0 = 1e-4
    tau = W @ np.full(n, e0)
    for k in (40, 150, 300):
        b = rad[::-1][k]
        expect = 2.0 * e0 * np.sqrt(rad[-1] ** 2 - b ** 2)
        assert abs(tau[k] / expect - 1.0) < 2e-3, k


@pytest.mark.parametrize("source", ["numpy", "torch"])
def test_transit_tau_linear_extinction(source):
    n = 600
    rad = np.linspace(70000.0, 80000.0, n)
    W = _transit_W(source, rad)
    a, c = 5e-4, -4e-9
    tau = W @ (a + c * rad)

    def integrand(r, b):
        return (a + c * r) * r / np.sqrt(r * r - b * b)

    for k in (60, 200, 400):
        b = rad[::-1][k]
        val, _ = quad(integrand, b, rad[-1], args=(b,), limit=200,
                      points=[b])
        assert abs(tau[k] / (2.0 * val) - 1.0) < 5e-3, k


@pytest.mark.parametrize("source", ["numpy", "torch"])
def test_eclipse_tau_is_vertical_integral(source):
    n = 500
    rad = np.linspace(70000.0, 80000.0, n)
    W = _eclipse_W(source, rad)
    # Exponential extinction with scale height H:
    H = 1500.0
    tau = W @ (1e-3 * np.exp(-(rad - rad[0]) / H))
    for ri in (80, 250, 480):
        rs = n - 1 - ri
        expect = 1e-3 * H * (np.exp(-(rad[rs] - rad[0]) / H) -
                             np.exp(-(rad[-1] - rad[0]) / H))
        assert abs(tau[ri] / expect - 1.0) < 1e-3, ri


@pytest.mark.parametrize("source", ["numpy", "torch"])
def test_tau_zero_at_top_and_grows(source):
    rad = np.sort(np.random.default_rng(0).uniform(70000, 80000, 80))
    W = _eclipse_W(source, rad)
    ex = np.random.default_rng(1).uniform(1e-6, 1e-3, 80)
    tau = W @ ex
    assert tau[0] == 0.0
    assert np.all(tau[1:] > 0)
    # Depth accumulates overall (strict monotonicity is not guaranteed by
    # the reference's parabolic tangent-point scheme on irregular data):
    assert tau[-1] > tau[10] > tau[1]
