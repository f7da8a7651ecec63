"""The port's geometry layer (numerics/simpson.py simpson_weights_torch,
rt/geometry.py, rt/tau.py transit_weights) against transit_tpu's on the
same inputs, made with numpy from a seed; rt/transmission.py is held in
tests/test_torch_transmission.py with the same helpers.

Tolerances: values in float64 within 1e-12 of the JAX function's max
|value| (max|a - b| / max|b|); gradients of a random linear functional
within 1e-9 of the max |jax.grad|; the numpy weight functions equal
JAX's exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transit_tpu.numerics.simpson import simpson_weights_jnp
from transit_tpu.rt import geometry as jgeom
from transit_tpu.rt import tau as jtau
from transit_tpu_torch.numerics.simpson import simpson_weights_torch
from transit_tpu_torch.rt import geometry as tgeom
from transit_tpu_torch.rt import tau as ttau
from transit_tpu_torch.rt import transmission as ttrans

torch.set_num_threads(1)

VAL_TOL = 1e-12
GRAD_TOL = 1e-9


def rel(a, b):
    """max |a - b| / max |b|, b the JAX result."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def radii(n=24, seed=3):
    rng = np.random.default_rng(seed)
    return np.sort(90000.0 + np.cumsum(rng.uniform(80, 160, n)))


def t64(a, grad=False):
    return torch.tensor(np.asarray(a), dtype=torch.float64,
                        requires_grad=grad)


def check_fn(jfn, tfn, args, seed=7):
    """Values of tfn against jfn in float64 (eager: XLA's fusion under
    jit moves the geometry by ~5e-11), and the gradient of sum(out * R)
    in every argument, R random (jitted: an eager grad of the vmapped
    rows takes ~20 s)."""
    ref = np.asarray(jfn(*(jnp.asarray(a) for a in args)))
    ts = [t64(a, grad=True) for a in args]
    out = tfn(*ts)
    assert rel(out.detach().numpy(), ref) <= VAL_TOL
    R = np.random.default_rng(seed).standard_normal(ref.shape)
    gj = jax.jit(jax.grad(lambda *a: jnp.sum(jfn(*a) * R),
                          argnums=tuple(range(len(args)))))(
                              *(jnp.asarray(a) for a in args))
    gt = torch.autograd.grad((out * t64(R)).sum(), ts)
    for a, b in zip(gt, gj):
        assert rel(a.numpy(), b) <= GRAD_TOL


@pytest.mark.parametrize("n_valid", [0, 1, 2, 3, 4, 7, 10, 11])
def test_simpson_weights_match_jax(n_valid):
    x = np.cumsum(np.random.default_rng(n_valid).uniform(0.5, 2.0, 11))
    if n_valid < 2:
        got = simpson_weights_torch(t64(x), n_valid).numpy()
        want = np.asarray(simpson_weights_jnp(jnp.asarray(x), n_valid))
        assert np.all(got == 0) and np.all(want == 0)
        return
    check_fn(lambda a: simpson_weights_jnp(a, n_valid),
             lambda a: simpson_weights_torch(a, n_valid), (x,))


def test_simpson_weights_rows_have_their_own_counts():
    """One batched call with a count per row equals one call per row."""
    rng = np.random.default_rng(1)
    x = np.cumsum(rng.uniform(0.5, 2.0, (6, 9)), axis=1)
    counts = np.array([0, 2, 3, 5, 8, 9])
    got = simpson_weights_torch(t64(x), torch.as_tensor(counts)).numpy()
    for row, c in zip(range(6), counts):
        want = np.asarray(simpson_weights_jnp(jnp.asarray(x[row]), int(c)))
        np.testing.assert_array_equal(got[row], want)


@pytest.mark.parametrize("name", ["eclipse", "transit"])
def test_weights_match_jax(name):
    jfn = getattr(jgeom, f"{name}_weights_jnp")
    tfn = getattr(tgeom, f"{name}_weights_torch")
    check_fn(jfn, tfn, (radii(),))


def test_weights_batched_equal_per_member():
    """Equal up to the batched product's summation order."""
    B = np.stack([radii(seed=s) for s in (3, 4, 5)])
    for name in ("eclipse", "transit"):
        tfn = getattr(tgeom, f"{name}_weights_torch")
        got = tfn(t64(B)).numpy()
        for b in range(3):
            assert rel(got[b], tfn(t64(B[b])).numpy()) <= VAL_TOL


@pytest.mark.parametrize("p0", [1.0, 0.37])
def test_radpress_matches_jax(p0):
    """p0 on a layer (the else branch, log(p0/p) = 0) and between layers
    (the interpolated reference temperature)."""
    rng = np.random.default_rng(11)
    nl = 24
    press = np.logspace(1, -6, nl)
    T = 1400.0 + 100.0 * rng.standard_normal(nl)
    mu = 2.3 + 0.01 * rng.standard_normal(nl)
    check_fn(lambda t, m: jgeom.radpress_jnp(980.0, p0, 92000.0, t, m,
                                             press, 1e5),
             lambda t, m: tgeom.radpress_torch(980.0, p0, 92000.0, t, m,
                                               press, 1e5), (T, mu))


def test_radpress_batched_equals_per_member():
    rng = np.random.default_rng(12)
    press = np.logspace(1, -6, 24)
    T = 1400.0 + 100.0 * rng.standard_normal((4, 24))
    mu = np.full((4, 24), 2.3)
    got = tgeom.radpress_torch(980.0, 1.0, 92000.0, t64(T), t64(mu), press,
                               1e5).numpy()
    for b in range(4):
        np.testing.assert_array_equal(got[b], tgeom.radpress_torch(
            980.0, 1.0, 92000.0, t64(T[b]), t64(mu[b]), press, 1e5).numpy())


def test_transit_weights_numpy_matches_jax():
    rad = radii(40, seed=8)
    for b in (rad[::-1].copy(), np.linspace(rad[0], rad[-1] + 50.0, 17)):
        np.testing.assert_array_equal(ttau.transit_weights(rad, b),
                                      jtau.transit_weights(rad, b))
    with pytest.raises(ValueError, match="below bottom layer"):
        ttau.transit_weights(rad, np.array([rad[0] - 1.0]))


def test_torch_weights_match_numpy():
    """The counterpart of tests/test_fast_and_forward.py:209 and :222:
    the tensor path weights and modulation table against numpy's."""
    rng = np.random.default_rng(3)
    rad = np.sort(90000.0 + np.cumsum(rng.uniform(80, 160, 24)))
    np.testing.assert_allclose(tgeom.eclipse_weights_torch(t64(rad)).numpy(),
                               ttau.eclipse_weights(rad), rtol=1e-9,
                               atol=1e-12)
    np.testing.assert_allclose(tgeom.transit_weights_torch(t64(rad)).numpy(),
                               ttau.transit_weights(rad, rad[::-1].copy()),
                               rtol=1e-9, atol=1e-12)
    ipv = np.sort(np.random.default_rng(4).uniform(1.0, 2.0, 13))
    np.testing.assert_allclose(
        ttrans.modulation_weight_table_torch(t64(ipv)).numpy(),
        ttrans.modulation_weight_table(ipv), rtol=1e-10, atol=1e-14)
