"""The port's Humlicek w4 Voigt (the plain version's profile) against
transit_tpu.opacities.voigt on an (x, y) grid that covers its three
regions."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from transit_tpu.opacities.voigt import (_humlicek_w as jw,
                                         voigt_k_humlicek as jk)
from transit_tpu_torch.opacities.voigt import (_humlicek_w as tw,
                                               voigt_k_humlicek as tk)

torch.set_num_threads(1)


def _grid():
    rng = np.random.default_rng(7)
    x = np.concatenate([np.linspace(0.0, 12.0, 121),
                        10.0 ** rng.uniform(-3, 4, 200)])
    y = np.concatenate([[1e-6, 1e-3, 0.05, 0.1, 0.3, 0.7, 1.0, 2.0, 5.0,
                         20.0], 10.0 ** rng.uniform(-4, 1.5, 30)])
    X, Y = np.meshgrid(x, y)
    return X.ravel(), Y.ravel()


def _regions(x, y):
    s = np.abs(x) + y
    in2 = s >= 5.5
    in4 = ~in2 & (y < 0.195 * np.abs(x) - 0.176)
    return in2, in4, ~(in2 | in4)


def test_grid_covers_all_regions():
    x, y = _grid()
    for r in _regions(x, y):
        assert r.sum() > 500


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-13),
                                       (torch.float32, 1e-6)])
def test_humlicek_matches_jax(dtype, tol):
    x, y = _grid()
    npdt = np.float64 if dtype == torch.float64 else np.float32
    xj, yj = jnp.asarray(x.astype(npdt)), jnp.asarray(y.astype(npdt))
    xt, yt = torch.as_tensor(x.astype(npdt)), torch.as_tensor(y.astype(npdt))
    ref = np.asarray(jk(xj, yj), dtype=np.float64)
    got = tk(xt, yt).double().numpy()
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, ref, rtol=tol, atol=0)
    # Both halves of the pair, region by region:
    rr, ri = (np.asarray(a, dtype=np.float64) for a in jw(xj, yj))
    gr, gi = (a.double().numpy() for a in tw(xt, yt))
    for m in _regions(x, y):
        scale = np.abs(rr[m]) + np.abs(ri[m])
        assert np.max(np.abs(gr[m] - rr[m]) / scale) < tol
        assert np.max(np.abs(gi[m] - ri[m]) / scale) < tol


@pytest.mark.parametrize("yv", [1e-8, 1e-4, 1e-2, 1.0, 1e2, 1e6])
def test_humlicek_finite_over_float32_plane(yv):
    """Padding elements hand the profile arbitrary (x, y), from x ~ 0 at
    y ~ 1e-8 to x ~ 1e8: the value stays finite (tests/test_voigt.py
    regression for the JAX kernel)."""
    xs = torch.as_tensor(10.0 ** np.linspace(-8, 8, 300), dtype=torch.float32)
    v = tk(xs, torch.full_like(xs, yv))
    assert torch.isfinite(v).all()
    ref = np.asarray(jk(jnp.asarray(xs.numpy()),
                        jnp.full((300,), yv, jnp.float32)))
    np.testing.assert_allclose(v.numpy(), ref, rtol=1e-6,
                               atol=1e-6 * np.abs(ref).max())


def _far_grid():
    """Far-wing arguments (|x| + y >= 5.5 and beyond X_ASYM), plus the
    floored junk lanes of padding (x ~ y ~ 0)."""
    rng = np.random.default_rng(11)
    x = np.concatenate([10.0 ** rng.uniform(0.7, 6, 400),
                        [0.0, 1e-8, 1e-3, 0.5]])
    y = np.concatenate([10.0 ** rng.uniform(-6, 2, 400),
                        [0.0, 1e-8, 1e-3, 0.5]])
    return x, y


@pytest.mark.parametrize("name", ["r2", "asym2"])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-13),
                                       (torch.float32, 1e-6)])
def test_far_kernels_match_jax(name, dtype, tol):
    from transit_tpu.opacities import voigt as jv
    from transit_tpu_torch.opacities import voigt as tv

    jfn = {"r2": jv._humlicek_w_r2, "asym2": jv._w_asym2}[name]
    tfn = {"r2": tv._humlicek_w_r2, "asym2": tv._w_asym2}[name]
    jk = {"r2": jv.voigt_k_humlicek_r2, "asym2": jv.voigt_k_asym2}[name]
    x, y = _far_grid()
    npdt = np.float64 if dtype == torch.float64 else np.float32
    xj, yj = jnp.asarray(x.astype(npdt)), jnp.asarray(y.astype(npdt))
    xt, yt = torch.as_tensor(x.astype(npdt)), torch.as_tensor(y.astype(npdt))
    got = tv.FAR_KERNELS[name](xt, yt).double().numpy()
    ref = np.asarray(jk(xj, yj), dtype=np.float64)
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, ref, rtol=tol, atol=0)
    rr, ri = (np.asarray(a, dtype=np.float64) for a in jfn(xj, yj))
    gr, gi = (a.double().numpy() for a in tfn(xt, yt))
    scale = np.maximum(np.abs(rr) + np.abs(ri), 1e-300)   # w(0) pads: 0
    assert np.max(np.abs(gr - rr) / scale) < tol
    assert np.max(np.abs(gi - ri) / scale) < tol


def test_r2_equals_w4_in_region_two():
    """Where |x| + y >= 5.5 the region-II kernel is the w4 kernel's own
    branch (tests/test_fast_and_forward.py's split-far premise)."""
    from transit_tpu_torch.opacities.voigt import voigt_k_humlicek_r2

    x, y = _far_grid()
    keep = x + y >= 5.5
    xt = torch.as_tensor(x[keep])
    yt = torch.as_tensor(y[keep])
    np.testing.assert_allclose(voigt_k_humlicek_r2(xt, yt).numpy(),
                               tk(xt, yt).numpy(), rtol=1e-14, atol=0)
