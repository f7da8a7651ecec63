"""Gradients of the port against the JAX package, float64: the three Voigt
functions' Faddeeva-identity backward against jax.grad of their custom
VJPs, the line-tile VJP (fast._block_val_bwd's counterpart) against torch
autograd through the plain forward, and the model's gradient in T and q
against jax.grad of transit_tpu's TransitModel.forward, unbanded and with
bands=6, plus a finite difference."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_conformance import make_config
from tests.test_torch_common import port_config
from transit_tpu.model import TransitModel as JModel
from transit_tpu.opacities import voigt as jv
from transit_tpu_torch.model import TransitModel
from transit_tpu_torch.opacities import voigt as tv
from transit_tpu_torch.opacities.kernel_lbl import (layer_tables,
                                                    plain_line_tiles,
                                                    plain_line_tiles_vjp,
                                                    strength_coef)

torch.set_num_threads(1)

TABLES = ("coef0", "densm", "alphal", "alphad_f")


def _xy_grid():
    """(x, y) crossing the three Humlicek regions, the far wings past the
    1e8 clamp, and the r2 |u|^2 floor and the asym2 |z|^2 floor (x ~ y ~
    0, the padding elements)."""
    rng = np.random.default_rng(3)
    x = np.concatenate([np.linspace(0.0, 12.0, 61),
                        10.0 ** rng.uniform(-3, 9, 120),
                        [0.0, 1e-8, 0.3, 0.7, 1e8, 2e8]])
    y = np.concatenate([[1e-8, 1e-4, 0.05, 0.3, 1.0, 3.0, 20.0],
                        10.0 ** rng.uniform(-6, 2, 12)])
    X, Y = np.meshgrid(x, y)
    return X.ravel(), Y.ravel()


@pytest.mark.parametrize("name", ["w4", "r2", "asym2"])
def test_voigt_gradients_match_jax(name):
    """d K / d x and d K / d y of the torch.autograd.Functions against
    jax.grad of voigt_k_humlicek, _r2 and asym2 (the same identity, not
    autograd through the rationals): <= 1e-12 relative; with y broadcast
    from (ny,) or (1, ny) the y cotangent is reduced back (_reduce_to)."""
    jk = {"w4": jv.voigt_k_humlicek, "r2": jv.voigt_k_humlicek_r2,
          "asym2": jv.voigt_k_asym2}[name]
    x, y = _xy_grid()
    in2 = x + y >= 5.5
    assert in2.any() and (~in2 & (y < 0.195 * x - 0.176)).any()
    assert (x >= 1e8).any() and ((y - x) ** 2 * (y + x) ** 2 < 1).any()
    gx, gy = jax.grad(lambda a, b: jnp.sum(jk(a, b)), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(y))
    xt = torch.tensor(x, requires_grad=True)
    yt = torch.tensor(y, requires_grad=True)
    tx, ty = torch.autograd.grad(tv.FAR_KERNELS[name](xt, yt).sum(),
                                 (xt, yt))
    for a, b in ((tx, gx), (ty, gy)):
        b = np.asarray(b)
        assert np.all(np.isfinite(a.numpy()))
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-12,
                                   atol=1e-12 * np.abs(b).max())
    # Broadcast: y (ny,) or (1, ny) against x (nx, ny), y's cotangent
    # summed back over x.
    xu, yu = np.unique(x), np.unique(y)
    xs = np.broadcast_to(xu[:, None], (xu.size, yu.size)).copy()
    for ys in (yu, yu[None, :]):
        gx, gy = jax.grad(lambda a, b: jnp.sum(jk(a, b)), argnums=(0, 1))(
            jnp.asarray(xs), jnp.asarray(ys))
        xt = torch.tensor(xs, requires_grad=True)
        yt = torch.tensor(ys, requires_grad=True)
        tx, ty = torch.autograd.grad(tv.FAR_KERNELS[name](xt, yt).sum(),
                                     (xt, yt))
        assert tx.shape == xs.shape and ty.shape == ys.shape
        for a, b in ((tx, gx), (ty, gy)):
            b = np.asarray(b)
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-12,
                                       atol=1e-12 * np.abs(b).max())


@pytest.fixture(scope="module")
def port0():
    return TransitModel(port_config(make_config("eclipse", 1e30)), mode="fast",
                        dtype=torch.float64, device="cpu")


def _leaves(m):
    """The file atmosphere's (T_cgs, densities, Z) as leaves."""
    T = torch.tensor(m.atm.temp * m.atm.tfct, requires_grad=True)
    dens = torch.tensor(m.atm.d, requires_grad=True)
    Z = m.partition(m._t(m.atm.temp)).detach().requires_grad_(True)
    return T, dens, Z


def _chain(tab, T, leaves, grads):
    """The VJP's cotangents of T and the tables chained by autograd to
    ``leaves`` through the tables' torch ops."""
    return torch.autograd.grad([T] + [tab[k] for k in TABLES], leaves,
                               [grads["temps"]] +
                               [grads[k] for k in TABLES],
                               allow_unused=True)


def test_line_tiles_vjp_matches_autograd(port0):
    """plain_line_tiles_vjp against torch autograd through
    plain_line_tiles on the fixture's unbanded plan, a seeded random
    cotangent, chained to (T, densities, Z) as JAX's own test compares
    the analytic VJP at the model's inputs
    (tests/test_fast_and_forward.py:377-408, rtol 1e-5, atol 1e-12
    max): the raw alphaD cotangent of far wings is a sum of terms that
    cancel, rounding noise in any order of operations."""
    m = port0
    kw = dict(wn_i=m.wns.i, dwn=m.wns.d, ethresh=m.cfg.ethreshold,
              nwidth=m.cfg.nwidth)
    leaves = _leaves(m)
    tab = layer_tables(m.fdev, leaves[0], leaves[1], leaves[2], m._molm_t,
                       m._molrad_t)
    out = plain_line_tiles(m.fplan, m.fdev, tab, leaves[0], **kw)
    g = torch.as_tensor(np.random.default_rng(4).standard_normal(out.shape))
    ref = torch.autograd.grad((out * g).sum(), leaves)
    leaves = _leaves(m)
    tab = layer_tables(m.fdev, leaves[0], leaves[1], leaves[2], m._molm_t,
                       m._molrad_t)
    grads = plain_line_tiles_vjp(m.fplan, m.fdev,
                                 {k: v.detach() for k, v in tab.items()},
                                 leaves[0].detach(), g, **kw)
    assert all(v.dtype == torch.float64 for v in grads.values())
    assert float(grads["temps"].abs().max()) > 0
    got = _chain(tab, leaves[0], leaves, grads)
    for a, b in zip(got, ref):
        b = b.numpy()
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5,
                                   atol=1e-12 * np.abs(b).max())
    # The strength coefficient's table: the same function as the
    # unbanded path's.
    assert torch.equal(tab["coef0"], strength_coef(m.fdev, leaves[2]))


@pytest.fixture(scope="module")
def jax_grads():
    """jax.grad of sum(forward) at the file profile, jitted, unbanded and
    bands=6 (f64)."""
    out = {}
    for bands in (0, 6):
        jm = JModel(make_config("eclipse", 1e30), mode="fast", bands=bands)
        fn = jax.jit(jax.grad(lambda t, q: jnp.sum(jm.forward(t, q)),
                              argnums=(0, 1)))
        out[bands] = [np.asarray(a) for a in fn(jnp.asarray(jm.atm.temp),
                                                jnp.asarray(jm.atm.q))]
    return out


@pytest.mark.parametrize("bands", [0, 6])
def test_model_gradient_matches_jax(jax_grads, bands):
    """torch.autograd.grad(forward(T, q).sum(), (T, q)) of the port's
    model (the line extinction through LineExtinction and the plain VJPs
    on the CPU) against jax.grad of the JAX model: max|a-b| <= 1e-9
    max|b|."""
    m = TransitModel(port_config(make_config("eclipse", 1e30)), mode="fast",
                     dtype=torch.float64, device="cpu", bands=bands)
    T = torch.tensor(m.atm.temp, requires_grad=True)
    q = torch.tensor(m.atm.q, requires_grad=True)
    got = torch.autograd.grad(m.forward(T, q).sum(), (T, q))
    for a, b in zip(got, jax_grads[bands]):
        assert a.shape == b.shape
        assert float(np.abs(a.numpy() - b).max()) <= 1e-9 * np.abs(b).max()


def test_model_gradient_finite_difference(port0):
    """A central difference in the temperature of one layer against the
    gradient (rtol 2e-3, as tests/test_fast_and_forward.py's
    test_forward_jit_and_grad)."""
    m = port0
    T0, q0 = m.atm.temp, m.atm.q
    T = torch.tensor(T0, requires_grad=True)
    gT, = torch.autograd.grad(m.forward(T, torch.tensor(q0)).sum(), T)
    layer, h = 10, 1e-3 * T0[10]
    f = []
    for sign in (1.0, -1.0):
        Tp = T0.copy()
        Tp[layer] += sign * h
        f.append(float(m.forward(Tp, q0).sum()))
    fd = (f[0] - f[1]) / (2 * h)
    assert abs(fd) > 0
    np.testing.assert_allclose(float(gT[layer]), fd, rtol=2e-3)


def test_forward_keeps_the_graph_of_other_dtypes():
    """A float64 T and q that require grad, given to a float32 model, stay
    in the graph (forward's as_tensor copies them differentiably): their
    gradients equal those of float32 leaves."""
    m = TransitModel(port_config(make_config("eclipse", 1e30)), mode="fast",
                     dtype=torch.float32, device="cpu", bands=6)
    grads = []
    for dt in (torch.float64, torch.float32):
        T = torch.tensor(m.atm.temp, dtype=dt, requires_grad=True)
        q = torch.tensor(m.atm.q, dtype=dt, requires_grad=True)
        g = torch.autograd.grad(m.forward(T, q).sum(), (T, q))
        assert all(a.dtype == dt for a in g)
        grads.append(g)
    for a, b in zip(*grads):
        assert float(b.abs().max()) > 0
        torch.testing.assert_close(a.float(), b, rtol=1e-6, atol=0)
