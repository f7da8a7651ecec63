"""Radius resampling (raddelt > 0) in the port's TransitModel, float64:
the resampled grid against the reference C golden (rad_ext of
ref_eclipse_raddelt, rtol 1e-9, as tests/test_aux.py:17); forward on the
atmosphere file's layers (re-splined onto the grid at every step) equal
to compute() (rtol 1e-8, as tests/test_config_validation.py:208) and to
transit_tpu's forward (max |a - b| / |b| <= 1e-10), in eclipse and
transit; its gradient in T against jax.grad (1e-9 of max); raddelt with
hydrostatic radii refused with the ConfigError, forward_batch with a
ValueError."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_conformance import GOLD, make_config
from tests.test_torch_common import port_config
from transit_tpu.model import TransitModel as JModel
from transit_tpu_torch.config import ConfigError
from transit_tpu_torch.model import TransitModel

torch.set_num_threads(1)


def _config(solution="eclipse"):
    cfg = make_config(solution, 1e30, raygrid="0 40 80")
    cfg.raddelt = 25.0
    return cfg


def _model(cfg):
    return TransitModel(port_config(cfg), mode="fast",
                        dtype=torch.float64, device="cpu")


def _file_profile():
    """T and q on the atmosphere file's layers."""
    m = TransitModel(port_config(make_config("eclipse", 1e30)), mode="fast",
                     dtype=torch.float64, device="cpu")
    return m.atm.temp.copy(), m.atm.q.copy()


def test_radius_grid_matches_reference():
    g = np.load(os.path.join(GOLD, "ref_eclipse_raddelt.npz"))
    m = _model(_config())
    assert m.rads_v.shape[0] == g["rad_ext"].shape[0]
    np.testing.assert_allclose(m.rads_v, g["rad_ext"], rtol=1e-9)
    assert m._atm0["radius"].shape[0] != m.rads_v.shape[0]


@pytest.mark.parametrize("solution", ["eclipse", "transit"])
def test_forward_on_file_layers(solution):
    cfg = _config(solution)
    m = _model(cfg)
    T0, q0 = _file_profile()
    got = m.forward(T0, q0).numpy()
    np.testing.assert_allclose(got, m.compute().spectrum.numpy(),
                               rtol=1e-8)
    jm = JModel(cfg, mode="fast")
    rng = np.random.default_rng(5)
    T = T0 + 40.0 + 10.0 * rng.standard_normal(T0.shape)
    q = q0 * (1.0 + 0.1 * rng.uniform(-1, 1, q0.shape))
    vg = jax.jit(jax.value_and_grad(
        lambda t: (lambda s: (jnp.sum(s), s))(jm.forward(t, jnp.asarray(q))),
        has_aux=True))
    for TT in (T0, T):
        (_, want), gj = vg(jnp.asarray(TT))
        t = torch.tensor(TT, requires_grad=True)
        spec = m.forward(t, q)
        got = spec.detach().numpy()
        assert np.max(np.abs(got - want) / np.abs(want)) <= 1e-10
        gt, = torch.autograd.grad(spec.sum(), t)
        gj = np.asarray(gj)
        assert np.max(np.abs(gt.numpy() - gj)) <= 1e-9 * np.max(np.abs(gj))


def test_raddelt_with_hydrostatic_radii_raises():
    cfg = _config()
    cfg.gsurf, cfg.refpress, cfg.refradius = 2200.0, 1.0, 7.0e9
    with pytest.raises(ConfigError, match="raddelt"):
        _model(cfg)


def test_forward_batch_refuses_raddelt():
    m = _model(_config())
    T0, q0 = _file_profile()
    with pytest.raises(ValueError, match="raddelt"):
        m.forward_batch(torch.as_tensor(T0)[None], torch.as_tensor(q0)[None])


def test_run_transit_takes_file_layers():
    m = _model(_config("transit"))
    T0, q0 = _file_profile()
    flat = np.concatenate([T0, q0.reshape(-1)])
    assert torch.equal(m.run_transit(flat), m.forward(T0, q0))
