"""Gradient-based posterior sampling for atmospheric retrieval.

The counterpart of transit_tpu.retrieval.  The reference's purpose is
Bayesian retrieval: BART drives thousands of gradient-free MCMC
iterations through run_transit (transit/src/transit.c:118-122), one
spectrum per sample per process.  The forward model here is
differentiable (``TransitModel.forward`` / ``forward_batch``), which
allows gradient-based samplers: Hamiltonian Monte Carlo moves
whole-profile proposals with O(1) autocorrelation instead of a random
walk.

The sampler is minimal: vectorized chains, a Python loop over samples
and leapfrog steps, a static leapfrog length, jointly accepted
Metropolis corrections, random numbers from an explicit
``torch.Generator``.  Plug in any differentiable log posterior over a
flat parameter vector, or supply ``vg_fn``, a batched value and gradient
(:func:`batched_value_and_grad` makes one from a log posterior over all
chains at once, e.g. through ``TransitModel.forward_batch``).  Optimisers
take ``torch.optim.Adam``.

ESS is estimated on the host with the standard multi-chain initial
positive sequence estimator (Geyer 1992).
"""

from __future__ import annotations

import numpy as np
import torch


def batched_value_and_grad(batched_logprob):
    """vg_fn for :func:`hmc_sample` from ``batched_logprob``: x (nchain,
    ndim) -> (nchain,) log posteriors of independent chains.  One
    backward pass of their sum gives every chain's gradient."""
    def vg(x):
        with torch.enable_grad():
            x = x.detach().requires_grad_(True)
            lp = batched_logprob(x)
            g, = torch.autograd.grad(lp.sum(), x)
        return lp.detach(), g
    return vg


def hmc_sample(logprob, x0, generator, step_size, n_leapfrog: int,
               n_samples: int, vg_fn=None):
    """Vectorized-chain HMC (transit_tpu retrieval.py:28-94).

    logprob: callable x (ndim,) -> scalar log posterior, differentiable
        under torch.func (used only when ``vg_fn`` is None).
    x0: (nchain, ndim) initial states.
    generator: the torch.Generator of the momenta and the acceptance
        draws, on x0's device.
    step_size: scalar or (ndim,) leapfrog step (per-dimension mass
        scaling folded in).
    vg_fn: optional batched (nchain, ndim) -> ((nchain,), (nchain, ndim))
        value-and-gradient override (defaults to
        vmap(grad_and_value(logprob))).

    Returns (samples, accept, state): samples (n_samples, nchain, ndim);
    accept (n_samples, nchain) bool; state = final (x, logp).
    """
    if vg_fn is None:
        gv = torch.func.vmap(torch.func.grad_and_value(logprob))

        def vg_fn(x):
            g, lp = gv(x)
            return lp, g
    x = torch.as_tensor(x0)
    eps = torch.as_tensor(step_size, dtype=x.dtype, device=x.device)
    nl = int(n_leapfrog)
    lp, g = vg_fn(x)
    samples, accept = [], []
    for _ in range(n_samples):
        p0 = torch.randn(x.shape, generator=generator, dtype=x.dtype,
                         device=x.device)
        # Leapfrog: initial half momentum step, nl position/momentum
        # steps with a trailing half step:
        p = p0 + 0.5 * eps * g
        xn, pn, lpn, gn = x, p, lp, g
        for i in range(nl):
            xn = xn + eps * pn
            lpn, gn = vg_fn(xn)
            pn = pn + (0.5 if i == nl - 1 else 1.0) * eps * gn
        dh = (lpn - 0.5 * torch.sum(pn * pn, dim=1)) - \
             (lp - 0.5 * torch.sum(p0 * p0, dim=1))
        u = torch.rand((x.shape[0],), generator=generator, dtype=x.dtype,
                       device=x.device)
        # NaN-safe rejection: a divergent leapfrog yields dh = NaN, which
        # compares False (reject).  Selection must be torch.where, NOT an
        # arithmetic blend: 0 * NaN would poison the kept state of every
        # rejected chain.
        acc = torch.log(u) < dh
        accb = acc[:, None]
        x = torch.where(accb, xn, x)
        lp = torch.where(acc, lpn, lp)
        g = torch.where(accb, gn, g)
        samples.append(x)
        accept.append(acc)
    return torch.stack(samples), torch.stack(accept), (x, lp)


def ess(samples) -> np.ndarray:
    """Per-dimension effective sample size over all chains.

    samples: (n_samples, nchain, ndim).  Multi-chain autocorrelation
    with Geyer's initial positive sequence truncation: rho averaged
    across chains (each demeaned by its own mean, variance pooled),
    summed over consecutive even-odd pairs while the pair sum stays
    positive.
    """
    if isinstance(samples, torch.Tensor):
        samples = samples.detach().cpu().numpy()
    s = np.asarray(samples, dtype=np.float64)
    n, c, d = s.shape
    out = np.empty(d)
    for j in range(d):
        x = s[:, :, j] - s[:, :, j].mean(axis=0, keepdims=True)
        var = (x * x).mean()
        if var == 0.0:
            out[j] = float(n * c)
            continue
        # FFT autocovariance per chain, averaged:
        nfft = 1
        while nfft < 2 * n:
            nfft *= 2
        f = np.fft.rfft(x, nfft, axis=0)
        acov = np.fft.irfft(f * np.conj(f), nfft, axis=0)[:n].mean(axis=1)
        rho = acov / acov[0]
        # Initial positive sequence over pair sums rho[2t+1] + rho[2t+2]:
        tau = 1.0
        t = 1
        while t + 1 < n:
            pair = rho[t] + rho[t + 1]
            if pair <= 0.0:
                break
            tau += 2.0 * pair
            t += 2
        out[j] = n * c / tau
    return out


def gaussian_logprob(forward, obs, sigma, prior_mean, prior_sigma):
    """Standard retrieval posterior: a Gaussian likelihood of a
    synthetic or observed spectrum plus an independent Gaussian prior on
    the (transformed) parameters.

    forward: x (..., ndim) -> spectrum (..., nwn), the differentiable
    model step (typically closing over TransitModel.forward, or
    forward_batch for a batch of chains, or the callable of
    TransitModel.make_forward(), which graphs either, and a parameter
    unpacking).
    The sums run over the last dimension, so the log posterior is
    (...,): a scalar for one chain (:func:`hmc_sample`'s ``logprob``),
    (nchain,) for a batch (:func:`batched_value_and_grad`)."""
    def logprob(x):
        r = (forward(x) - obs) / sigma
        pr = (x - prior_mean) / prior_sigma
        return -0.5 * (torch.sum(r * r, dim=-1) + torch.sum(pr * pr, dim=-1))

    return logprob


def knot_profile(knots, nlayer: int):
    """Monotone-x linear interpolation of ``knots`` (..., K) onto nlayer
    layers at x = 0..nlayer-1, knots at linspace(0, nlayer-1, K) (the
    usual low-dimensional temperature parametrization: retrieval samples
    K knot values, the atmosphere gets a smooth profile).
    Differentiable; endpoints pinned to the first/last knot.  The
    formula and the segment at a knot are jnp.interp's (a knot takes the
    segment on its right; the last knot the last segment), so values and
    gradients equal transit_tpu's knot_profile."""
    k = torch.as_tensor(knots)
    K = k.shape[-1]
    xk = torch.linspace(0.0, float(nlayer - 1), K, dtype=k.dtype,
                        device=k.device)
    x = torch.arange(nlayer, dtype=k.dtype, device=k.device)
    i = torch.clamp(torch.searchsorted(xk, x, right=True), 1, K - 1)
    df = k[..., i] - k[..., i - 1]
    dx = xk[i] - xk[i - 1]
    delta = x - xk[i - 1]
    npdt = torch.empty((), dtype=k.dtype).numpy().dtype
    eps = float(np.spacing(np.finfo(npdt).eps))
    dx0 = dx.abs() <= eps
    f = torch.where(dx0, k[..., i - 1],
                    k[..., i - 1] + (delta / torch.where(
                        dx0, torch.ones_like(dx), dx)) * df)
    f = torch.where(x < xk[0], k[..., :1], f)
    return torch.where(x > xk[-1], k[..., -1:], f)
