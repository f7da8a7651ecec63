"""The port's unbanded TransitModel in transit geometry with
hydrostatic radii (gsurf 980, refpress 1, refradius 92000: the radii,
the path weights and the modulation table rebuilt from T and q at every
step) against transit_tpu's, with the checks and tolerances of
tests/test_torch_transit_model.py; the step's radii against JAX's
radpress; the eclipse geometry's hydrostatic step."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_conformance import make_config
from tests.test_torch_common import port_config
from tests.test_torch_transit_model import (
    HYDRO, TOL64, check_compute, check_forward, check_forward_batch,
    check_gradient, make_pair, profiles, rel)
from transit_tpu.model import TransitModel as JModel
from transit_tpu.rt.geometry import radpress_jnp
from transit_tpu_torch.model import TransitModel

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pair():
    return make_pair(True, 0)


def test_compute_matches_jax(pair):
    """compute() keeps the file's radii, as JAX's does."""
    check_compute(pair)


def test_forward_matches_jax(pair):
    check_forward(pair)


def test_gradient_matches_jax(pair):
    check_gradient(pair)


def test_forward_batch_matches_jax(pair):
    check_forward_batch(pair)


def test_geometry_rebuilt_per_step(pair):
    """The step's radii equal JAX's radpress on the step's T and mm, and
    another T gives other radii and another spectrum."""
    jm, tm, prof, _ = pair
    T, q = prof[0]
    mm = tm.mean_mass(torch.as_tensor(q))
    radii, W, Wmod = tm.geometry(torch.as_tensor(T), torch.as_tensor(q))
    want = np.asarray(radpress_jnp(980.0, 1.0, 92000.0, jnp.asarray(T),
                                   jnp.asarray(mm.numpy()), jm.atm.press,
                                   jm.rfct))
    assert rel(radii.numpy(), want) <= 1e-12
    assert W.shape == (T.shape[0],) * 2 and Wmod.shape == (T.shape[0] + 1,
                                                           T.shape[0])
    assert not np.allclose(radii.numpy(), jm.rads_v)
    assert not torch.equal(tm.forward(T, q), tm.forward(T + 100.0, q))


def test_eclipse_hydrostatic_matches_jax():
    """Eclipse geometry with hydrostatic radii: forward and forward_batch
    against JAX's."""
    cfg = make_config("eclipse", 1e30)
    for k, v in HYDRO.items():
        setattr(cfg, k, v)
    jm = JModel(cfg, mode="fast")
    tm = TransitModel(port_config(cfg), mode="fast",
                      dtype=torch.float64, device="cpu")
    prof = profiles(jm)
    fwd = jax.jit(jm.forward)
    for T, q in prof:
        want = np.asarray(fwd(jnp.asarray(T), jnp.asarray(q)))
        assert rel(tm.forward(T, q).numpy(), want) <= TOL64
    Tb, qb = (np.stack(a) for a in zip(*prof))
    want = np.asarray(jax.jit(jm.forward_batch)(jnp.asarray(Tb),
                                                jnp.asarray(qb)))
    got = tm.forward_batch(torch.tensor(Tb), torch.tensor(qb)).numpy()
    assert rel(got, want) <= TOL64
