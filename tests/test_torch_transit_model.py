"""The port's TransitModel in transit geometry (fast mode) against
transit_tpu's TransitModel(mode="fast") on the transit fixture
(make_config("transit", ...)): here the unbanded model with the
atmosphere file's radii.  The helpers here run the same checks on the
other cases, one file each (JAX compiles each model's steps, ~10-20 s):
tests/test_torch_transit_banded.py (bands=4), _hydro.py and
_hydro_banded.py (hydrostatic radii: gsurf 980, refpress 1, refradius
92000), _f32.py (float32), _golden.py (the reference C goldens).

Tolerances: float64 spectra, tau and extinction within 1e-10 of JAX's
(max|a - b| / |b|); gradients in T and q within 1e-9 of the max
|jax.grad|; float32 against JAX's float32 model elementwise at 1e-4
(|a - b| / (|a| + 1e-6 max|a|), as tests/test_torch_banded_fine_f32.py);
forward_batch (B = 2) against JAX's forward_batch at 1e-10; run_transit
equal to forward; modlevel = -1 (toomuch 3e7, reached at about half the
wavenumbers) at 1e-10, the unreached wavenumbers -1 in both."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_conformance import make_config
from tests.test_torch_common import port_config
from tests.test_torch_common import rel as rel_elementwise
from transit_tpu.model import TransitModel as JModel
from transit_tpu_torch.model import TransitModel

torch.set_num_threads(1)

TOL64 = 1e-10
GRAD_TOL = 1e-9
TOL32 = 1e-4
HYDRO = dict(gsurf=980.0, refpress=1.0, refradius=92000.0)


def rel(a, b):
    """max |a - b| / |b|, b the JAX result (exact zeros must match)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / (np.abs(b) + 1e-30 *
                                          np.abs(b).max())))


def transit_config(hydro: bool, toomuch=1e30):
    cfg = make_config("transit", toomuch)
    if hydro:
        for k, v in HYDRO.items():
            setattr(cfg, k, v)
    return cfg


def profiles(m):
    """Two perturbed profiles of the file atmosphere, numpy from a seed."""
    rng = np.random.default_rng(42)
    nl = m.atm.nlayers
    out = []
    for dT in (60.0, -45.0):
        T = m.atm.temp + dT + 15.0 * rng.standard_normal(nl)
        q = m.atm.q * (1.0 + 0.2 * rng.uniform(-1, 1, m.atm.q.shape))
        out.append((T, q))
    return out


def make_pair(hydro: bool, bands: int):
    """The JAX model and the port's (float64) on one configuration, and
    JAX's results: compute's spectrum, tau and extinction, forward and
    the gradient of sum(forward) on the two profiles, and forward_batch
    of both (all jitted)."""
    cfg = transit_config(hydro)
    jm = JModel(cfg, mode="fast", bands=bands)
    tm = TransitModel(port_config(cfg), mode="fast",
                      dtype=torch.float64, device="cpu",
                      bands=bands)
    radii, W = jnp.asarray(jm.rads_v), jnp.asarray(jm.W)
    Wmod = jnp.asarray(jm.Wmod)

    @jax.jit
    def full(T, q, d):
        r = jm._spectrum(T, q, d, radii, W, Wmod, full_result=True)
        return r.spectrum, r.tau, r.extinction

    ref = {"compute": [np.asarray(a) for a in full(
        *(jnp.asarray(a) for a in (jm.atm.temp, jm.atm.q, jm.atm.d)))]}
    vg = jax.jit(jax.value_and_grad(
        lambda t, qq: (lambda s: (jnp.sum(s), s))(jm.forward(t, qq)),
        argnums=(0, 1), has_aux=True))
    prof = profiles(jm)
    out = [vg(jnp.asarray(T), jnp.asarray(q)) for T, q in prof]
    ref["forward"] = [np.asarray(s) for (_, s), _ in out]
    ref["grad"] = [np.asarray(g) for g in out[0][1]]
    Tb, qb = (np.stack(a) for a in zip(*prof))
    ref["batch"] = np.asarray(jax.jit(jm.forward_batch)(jnp.asarray(Tb),
                                                        jnp.asarray(qb)))
    return jm, tm, prof, ref


def check_compute(pair):
    _, tm, _, ref = pair
    spec, tau, ext = ref["compute"]
    r = tm.compute()
    assert r.intensity is None
    assert rel(r.spectrum.numpy(), spec) <= TOL64
    assert rel(r.extinction.numpy(), ext) <= TOL64
    nz = tau > 0
    assert rel(r.tau.numpy()[nz], tau[nz]) <= TOL64
    assert np.all(r.tau.numpy()[~nz] == 0)


def check_forward(pair):
    _, tm, prof, ref = pair
    for (T, q), want in zip(prof, ref["forward"]):
        assert rel(tm.forward(T, q).numpy(), want) <= TOL64


def check_gradient(pair):
    _, tm, prof, ref = pair
    T, q = (torch.tensor(a, requires_grad=True) for a in prof[0])
    got = torch.autograd.grad(tm.forward(T, q).sum(), (T, q))
    for a, b in zip(got, ref["grad"]):
        assert np.max(np.abs(a.numpy() - b)) <= GRAD_TOL * np.max(np.abs(b))


def check_forward_batch(pair):
    _, tm, prof, ref = pair
    Tb, qb = (torch.tensor(np.stack(a)) for a in zip(*prof))
    assert rel(tm.forward_batch(Tb, qb).numpy(), ref["batch"]) <= TOL64


def check_float32(hydro: bool, bands: int):
    """The port in float32 against JAX's float32 model on both
    profiles."""
    cfg = transit_config(hydro)
    jm = JModel(cfg, mode="fast", bands=bands, dtype=jnp.float32)
    tm = TransitModel(port_config(cfg), mode="fast",
                      dtype=torch.float32, device="cpu",
                      bands=bands)
    fwd = jax.jit(jm.forward)
    for T, q in profiles(jm):
        want = np.asarray(fwd(jnp.asarray(T, jnp.float32),
                              jnp.asarray(q, jnp.float32)))
        got = tm.forward(T, q)
        assert got.dtype == torch.float32
        assert rel_elementwise(want, got.numpy()) <= TOL32


@pytest.fixture(scope="module")
def pair():
    return make_pair(False, 0)


def test_compute_matches_jax(pair):
    check_compute(pair)


def test_forward_matches_jax(pair):
    check_forward(pair)


def test_gradient_matches_jax(pair):
    check_gradient(pair)


def test_forward_batch_matches_jax(pair):
    check_forward_batch(pair)


def test_run_transit_equals_forward(pair):
    _, tm, prof, _ = pair
    T, q = prof[0]
    flat = np.concatenate([T, q.reshape(-1)])
    assert torch.equal(tm.run_transit(flat), tm.forward(T, q))


def test_modlevel_m1_matches_jax():
    """The opaque-disc modulation (modulationm1) at toomuch 3e7: the
    radius where tau reaches toomuch, -1 where it does not."""
    cfg = transit_config(False, toomuch=3e7)
    cfg.modlevel = -1
    jm = JModel(cfg, mode="fast")
    tm = TransitModel(port_config(cfg), mode="fast",
                      dtype=torch.float64, device="cpu")
    T, q = profiles(jm)[0]
    want = np.asarray(jax.jit(jm.forward)(jnp.asarray(T), jnp.asarray(q)))
    got = tm.forward(T, q).numpy()
    assert np.any(want == -1.0) and np.any(want > 0)
    np.testing.assert_array_equal(got == -1.0, want == -1.0)
    assert rel(got, want) <= TOL64
