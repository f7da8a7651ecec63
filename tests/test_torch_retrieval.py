"""The port's retrieval module (transit_tpu_torch/retrieval.py) and
orbit (rt/orbit.py) against transit_tpu's and against the statistical
bounds of tests/test_hmc.py.

Tolerances: knot_profile in float64 within 1e-14 of jnp.interp's values
and its Jacobian within 1e-14; ess equal to transit_tpu's bit for bit on
the same samples; the HMC recovery of a correlated Gaussian with
test_hmc.py's bounds (acceptance in (0.6, 1], mean atol 0.15,
covariance atol 0.4, ESS > 200 of 8000 draws); the HMC posterior
recovery of tests/test_hmc.py:64 through the port's model, float64 (a
4-knot temperature profile of the fixture atmosphere through
forward_batch with batched_value_and_grad; acceptance > 0.4, posterior
means within 0.02 of the truth and covering it within 4 sigma + 5e-4);
orbit as tests/test_aux.py:112-121.  The Adam recovery is in
tests/test_torch_retrieval_adam.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_conformance import make_config
from tests.test_torch_common import port_config
from transit_tpu import retrieval as jret
from transit_tpu_torch.model import TransitModel
from transit_tpu_torch.retrieval import (batched_value_and_grad, ess,
                                         gaussian_logprob, hmc_sample,
                                         knot_profile)
from transit_tpu_torch.rt.orbit import kepler_solve, planet_position

torch.set_num_threads(1)

# The model posterior, cut to size for the CPU (a step of the plain line
# sum on 31 fixture wavenumbers takes ~0.3 s for 6 chains): chains,
# samples, leapfrog steps and wavenumbers; the step size and the
# criteria are test_hmc.py's.
WNHIGH_HMC = 2010.0
NCHAIN = 4
N_SAMPLES = 25
N_LEAPFROG = 3


def test_knot_profile_values():
    p = knot_profile(torch.tensor([1.0, 3.0, 2.0], dtype=torch.float64), 5)
    np.testing.assert_allclose(p.numpy(), [1.0, 2.0, 3.0, 2.5, 2.0])


@pytest.mark.parametrize("K,nl", [(4, 20), (8, 100), (3, 5)])
def test_knot_profile_matches_jax(K, nl):
    """Values and the Jacobian in the knots, the knots' own layers
    included (there the segment on the right, and at the last knot the
    last segment, as jnp.interp takes them)."""
    k = np.random.default_rng(K).uniform(1000.0, 2000.0, K)
    want = np.asarray(jret.knot_profile(jnp.asarray(k), nl))
    got = knot_profile(torch.tensor(k), nl).numpy()
    assert np.max(np.abs(got - want)) <= 1e-14 * np.max(np.abs(want))
    Jj = np.asarray(jax.jacfwd(lambda z: jret.knot_profile(z, nl))(
        jnp.asarray(k)))
    Jt = torch.autograd.functional.jacobian(
        lambda z: knot_profile(z, nl), torch.tensor(k)).numpy()
    assert np.max(np.abs(Jt - Jj)) <= 1e-14
    # Batched knots give every row's profile:
    kb = np.stack([k, k * 1.1])
    np.testing.assert_array_equal(knot_profile(torch.tensor(kb), nl)[1],
                                  knot_profile(torch.tensor(kb[1]), nl))


def test_ess_matches_jax():
    rng = np.random.default_rng(2)
    for s in (rng.normal(size=(200, 4, 3)),
              np.cumsum(rng.normal(size=(150, 3, 2)), axis=0),
              np.ones((10, 2, 1))):
        np.testing.assert_array_equal(ess(s), jret.ess(s))
        np.testing.assert_array_equal(ess(torch.tensor(s)), jret.ess(s))


def test_hmc_recovers_correlated_gaussian():
    """Analytic pin (tests/test_hmc.py:17): sampling a correlated 3-D
    Gaussian must recover its mean and covariance, with healthy
    acceptance and ESS; the default vg_fn (vmap of grad_and_value)."""
    cov = np.array([[1.0, 0.6, 0.2],
                    [0.6, 2.0, -0.3],
                    [0.2, -0.3, 0.5]])
    mu = np.array([1.0, -2.0, 0.5])
    prec = torch.tensor(np.linalg.inv(cov))
    mu_t = torch.tensor(mu)

    def logprob(x):
        d = x - mu_t
        return -0.5 * d @ prec @ d

    gen = torch.Generator().manual_seed(0)
    x0 = torch.zeros((16, 3), dtype=torch.float64) + mu_t + 0.1
    samples, accept, (xf, lpf) = hmc_sample(logprob, x0, gen, step_size=0.4,
                                            n_leapfrog=8, n_samples=600)
    assert samples.shape == (600, 16, 3) and accept.dtype == torch.bool
    assert torch.equal(xf, samples[-1]) and lpf.shape == (16,)
    acc = float(accept.double().mean())
    assert 0.6 < acc <= 1.0, acc
    s = samples[100:].reshape(-1, 3).numpy()          # drop warmup
    np.testing.assert_allclose(s.mean(axis=0), mu, atol=0.15)
    np.testing.assert_allclose(np.cov(s.T), cov, atol=0.4)
    e = ess(samples[100:])
    assert np.all(e > 200), e                        # of 8000 draws


def test_hmc_rejects_divergent_chains_without_nan():
    """A chain whose leapfrog diverges (NaN log posterior) is rejected
    and keeps its finite state: the selection is torch.where."""
    def logprob(x):
        return torch.where(x[0] > 0.5, torch.tensor(float("nan"),
                                                    dtype=x.dtype),
                           -0.5 * torch.sum(x * x))

    gen = torch.Generator().manual_seed(3)
    x0 = torch.zeros((8, 2), dtype=torch.float64)
    samples, accept, (xf, lpf) = hmc_sample(logprob, x0, gen, 0.5, 4, 20)
    assert torch.isfinite(samples).all() and torch.isfinite(lpf).all()
    assert bool(accept.any()) and not bool(accept.all())
    assert bool((samples[..., 0] <= 0.5).all())


def test_gaussian_logprob_batched_equals_per_chain():
    obs = torch.tensor([1.0, 2.0, 3.0], dtype=torch.float64)

    def fwd(x):
        return x[..., :1] * torch.tensor([1.0, 2.0, 3.0], dtype=x.dtype)

    lp = gaussian_logprob(fwd, obs, 0.1, prior_mean=0.0, prior_sigma=2.0)
    x = torch.tensor([[1.0, 0.5], [1.2, -0.3]], dtype=torch.float64)
    want = jret.gaussian_logprob(
        lambda z: z[:1] * jnp.asarray([1.0, 2.0, 3.0]), jnp.asarray(obs),
        0.1, 0.0, 2.0)
    for i in range(2):
        assert float(lp(x[i])) == pytest.approx(
            float(want(jnp.asarray(x[i].numpy()))), rel=1e-14)
        assert float(lp(x)[i]) == float(lp(x[i]))


def test_hmc_model_posterior_recovery():
    cfg = make_config("eclipse", 1e30)
    cfg.wnhigh = WNHIGH_HMC             # keep the CPU test small
    m = TransitModel(port_config(cfg), dtype=torch.float64, device="cpu")
    nl = m.atm.nlayers
    q = torch.as_tensor(m.atm.q)
    nk, nchain = 4, NCHAIN

    def fwd(z):
        # z = log of the knot temperatures, (nchain, nk):
        T = knot_profile(torch.exp(z), nl)
        return m.forward_batch(T, q.expand((z.shape[0],) + q.shape))

    # Truth = the knot model at the layer-mean temperature (so the
    # posterior mode is exactly representable):
    z_true = torch.full((nk,), float(np.log(np.mean(m.atm.temp))),
                        dtype=torch.float64)
    obs = fwd(z_true[None])[0]
    sigma = 1e-3 * float(obs.abs().mean())
    logprob = gaussian_logprob(fwd, obs, sigma, prior_mean=float(z_true[0]),
                               prior_sigma=0.5)
    gen = torch.Generator().manual_seed(1)
    x0 = z_true[None, :] + 0.02 * torch.randn(
        (nchain, nk), generator=gen, dtype=torch.float64)
    samples, accept, _ = hmc_sample(None, x0, gen, step_size=2e-4,
                                    n_leapfrog=N_LEAPFROG,
                                    n_samples=N_SAMPLES,
                                    vg_fn=batched_value_and_grad(logprob))
    acc = float(accept.double().mean())
    assert acc > 0.4, acc
    s = samples[N_SAMPLES // 5:].reshape(-1, nk).numpy()
    zt = z_true.numpy()
    mean, std = s.mean(axis=0), s.std(axis=0) + 1e-12
    # Posterior concentrates on the truth (tight likelihood):
    assert np.all(np.abs(mean - zt) < 0.02), (mean, zt)
    # and covers it:
    assert np.all(np.abs(mean - zt) < 4.0 * std + 5e-4)


def test_ess_iid_vs_sticky():
    """ESS sanity (tests/test_hmc.py:45): iid draws score ~n, a
    nearly-constant (sticky) chain scores far less."""
    rng = np.random.default_rng(3)
    iid = rng.normal(size=(500, 4, 1))
    e_iid = ess(iid)[0]
    ar = np.empty((500, 4, 1))
    ar[0] = rng.normal(size=(4, 1))
    for i in range(1, 500):
        ar[i] = 0.98 * ar[i - 1] + 0.02 * rng.normal(size=(4, 1))
    e_ar = ess(ar)[0]
    assert e_iid > 1000.0
    assert e_ar < 0.2 * e_iid


def test_kepler_orbit():
    """tests/test_aux.py:112, and equal to transit_tpu's."""
    from transit_tpu.rt import orbit as jorbit
    # Circular orbit: E == M
    np.testing.assert_allclose(kepler_solve(1.3, 0.0), 1.3)
    # Eccentric: verify Kepler's equation holds
    E = kepler_solve(2.0, 0.3)
    np.testing.assert_allclose(E - 0.3 * np.sin(E), 2.0, rtol=1e-12)
    x, y, r = planet_position(smaxis=0.05, time=0.0, ecc=0.0)
    assert r > 0
    kw = dict(smaxis=0.05, time=1.5, incl=89.0, ecc=0.01, arg_per=90.0,
              period=3.0)
    assert planet_position(**kw) == jorbit.planet_position(**kw)
    M = np.linspace(0.0, 6.0, 7)
    np.testing.assert_array_equal(kepler_solve(M, 0.2),
                                  jorbit.kepler_solve(M, 0.2))
