"""The port's TransitModel (fast mode, unbanded plan, eclipse) against
transit_tpu's TransitModel(mode="fast") on the eclipse fixture, and
against the reference C goldens."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import test_conformance
from tests.test_conformance import GOLD, make_config
from transit_tpu.model import TransitModel as JModel
from transit_tpu_torch.config import TransitConfig
from transit_tpu_torch.model import TransitModel

torch.set_num_threads(1)


def _profiles(m):
    """The file profile and two perturbed ones, made with numpy from a
    seed."""
    rng = np.random.default_rng(42)
    nl = m.atm.nlayers
    out = [(m.atm.temp, m.atm.q)]
    for dT in (60.0, -45.0):
        T = m.atm.temp + dT + 15.0 * rng.standard_normal(nl)
        q = m.atm.q * (1.0 + 0.2 * rng.uniform(-1, 1, m.atm.q.shape))
        out.append((T, q))
    return out


@pytest.fixture(scope="module")
def ref():
    """JAX results: the f64 static-atmosphere spectrum (compute's
    _spectrum, jitted) and forward on the three profiles in f64 and
    f32."""
    jm = JModel(make_config("eclipse", 1e30), mode="fast")
    radii = jnp.asarray(jm.rads_v)
    W = jnp.asarray(jm.W)

    @jax.jit
    def full(T, q, d):
        r = jm._spectrum(T, q, d, radii, W, None, full_result=True)
        return r.spectrum, r.tau, r.extinction

    res = [np.asarray(a) for a in full(jnp.asarray(jm.atm.temp),
                                       jnp.asarray(jm.atm.q),
                                       jnp.asarray(jm.atm.d))]
    fwd = jax.jit(jm.forward)
    specs = [np.asarray(fwd(jnp.asarray(T), jnp.asarray(q)))
             for T, q in _profiles(jm)]
    j32 = JModel(make_config("eclipse", 1e30), mode="fast",
                 dtype=jnp.float32)
    fwd32 = jax.jit(j32.forward)
    specs32 = [np.asarray(fwd32(jnp.asarray(T, jnp.float32),
                                jnp.asarray(q, jnp.float32)))
               for T, q in _profiles(jm)]
    return jm, res, (specs, specs32)


def _model(dtype, cfg=None):
    cfg = cfg if cfg is not None else make_config("eclipse", 1e30)
    return TransitModel(TransitConfig(**dataclasses.asdict(cfg)), mode="fast",
                        dtype=dtype, device="cpu")


@pytest.fixture(scope="module")
def port64():
    return _model(torch.float64)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b) / (np.abs(b) + 1e-30 * np.abs(b).max()))


def test_compute_matches_jax_f64(ref, port64):
    _, (spec, tau, ext), _ = ref
    r = port64.compute()
    assert r.spectrum.dtype == torch.float64
    assert _rel(r.spectrum.numpy(), spec) <= 1e-10
    assert _rel(r.extinction.numpy(), ext) <= 1e-10
    nz = tau > 0
    assert _rel(r.tau.numpy()[nz], tau[nz]) <= 1e-10
    assert np.all(r.tau.numpy()[~nz] == 0)


@pytest.mark.parametrize("i", [0, 1, 2])
def test_forward_matches_jax(ref, port64, i):
    """f64 against f64; f32 against JAX's f32 model (float32 itself
    moves the fixture spectrum by ~1.2e-4 from f64, in both packages)."""
    jm, _, (specs, specs32) = ref
    T, q = _profiles(jm)[i]
    s64 = port64.forward(T, q).numpy()
    assert _rel(s64, specs[i]) <= 1e-10
    s32 = _model(torch.float32).forward(T, q)
    assert s32.dtype == torch.float32
    assert _rel(s32.numpy(), specs32[i]) <= 1e-4


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_fast_mode_against_c_golden(dtype):
    """The fast-mode thresholds of tests/test_conformance.py:138-144, on
    its three-isotope, two-molecule configuration."""
    g = np.load(os.path.join(GOLD, "ref_multi_eclipse.npz"))
    cfg = test_conformance.TestMultiDatabase.multi_config(None, "eclipse")
    m = _model(dtype, cfg)
    assert m.iso.mass.shape[0] == 3
    spec = m.compute().spectrum.double().numpy()
    rel = np.abs(spec / g["spec"] - 1.0)
    assert np.median(rel) < 2e-3
    assert rel.max() < 0.1


def test_setters_change_the_spectrum(port64):
    base = port64.compute().spectrum
    m = _model(torch.float64)
    m.set_scattering(2.0)
    assert not torch.allclose(m.compute().spectrum, base)
