"""The gradient of the port's exact-mode ``forward`` against jax.grad of
transit_tpu's, float64, on the conformance fixture's 2000-2040 cm-1
(tests/test_torch_exact_grad.py's gradient_matches_jax) in transit geometry
with hydrostatic radii (tests/test_torch_transit_model.py's HYDRO:
gsurf 980, refpress 1, refradius 92000; every step rebuilds the radii,
the path weights and the modulation table), within 1e-9 of each
gradient's max."""

import torch

from tests.test_conformance import make_config
from tests.test_torch_exact_grad import gradient_matches_jax
from tests.test_torch_transit_model import HYDRO

torch.set_num_threads(1)


def test_transit_hydrostatic_gradient_matches_jax():
    cfg = make_config("transit", 1e30)
    for k, v in HYDRO.items():
        setattr(cfg, k, v)
    gradient_matches_jax(cfg)
