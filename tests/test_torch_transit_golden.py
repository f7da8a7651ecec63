"""The port's transit spectra against the reference C goldens of
tests/test_conformance.py (ref_transit, ref_transit_toomuch,
ref_transit_polar, ref_transit_cloud1, ref_multi_transit), float64 fast
mode, compute() on the file atmosphere.  Fast mode is not the
reference's profile-table scheme, so the bound is JAX's own fast mode on
the same configuration (its compute's spectrum, jitted): the port's
largest relative deviation from the golden is at most JAX fast mode's
(measured here) plus 1e-6, and its median below 2e-3 (the fast-mode
median bound of tests/test_conformance.py:143)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import test_conformance
from tests.test_conformance import GOLD, make_config
from tests.test_torch_common import port_config
from transit_tpu.model import TransitModel as JModel
from transit_tpu_torch.model import TransitModel

torch.set_num_threads(1)

SLACK = 1e-6


def _config(name):
    if name == "ref_multi_transit":
        return test_conformance.TestMultiDatabase.multi_config(None,
                                                               "transit")
    cfg = make_config("transit", 5.0 if name == "ref_transit_toomuch"
                      else 1e30)
    if name == "ref_transit_polar":
        cfg.scattering = "polar"
    if name == "ref_transit_cloud1":
        cfg.cloud = "ext,1e-8,-1.0,1.5"
    return cfg


@pytest.mark.parametrize("name", [
    "ref_transit", "ref_transit_toomuch", "ref_transit_polar",
    "ref_transit_cloud1", "ref_multi_transit"])
def test_transit_golden(name):
    g = np.load(os.path.join(GOLD, f"{name}.npz"))["spec"]
    cfg = _config(name)
    jm = JModel(cfg, mode="fast")
    geom = (jnp.asarray(jm.rads_v), jnp.asarray(jm.W), jnp.asarray(jm.Wmod))
    spec_j = np.asarray(jax.jit(lambda T, q, d: jm._spectrum(
        T, q, d, *geom, full_result=False))(
            *(jnp.asarray(a) for a in (jm.atm.temp, jm.atm.q, jm.atm.d))))
    r = TransitModel(port_config(cfg), dtype=torch.float64,
                     device="cpu").compute()
    dev_j = np.max(np.abs(spec_j / g - 1.0))
    dev_t = np.max(np.abs(r.spectrum.numpy() / g - 1.0))
    assert dev_t <= dev_j + SLACK, (dev_t, dev_j)
    assert np.median(np.abs(r.spectrum.numpy() / g - 1.0)) < 2e-3
