"""The port's ``make_forward`` in transit geometry with hydrostatic radii
(gsurf 980, refpress 1, refradius 92000: radii, path weights and the
modulation table rebuilt from T and q at every step) against
transit_tpu's, fast mode, float64 on the CPU
(tests/test_torch_make_forward.py's checks: rtol 1e-12 against the
port's ``forward`` and JAX's ``make_forward()``, the gradient within
1e-9 of the max)."""

import torch

from tests.test_conformance import make_config
from tests.test_torch_make_forward import make_forward_matches_jax

torch.set_num_threads(1)

HYDRO = dict(gsurf=980.0, refpress=1.0, refradius=92000.0)


def test_hydrostatic_transit_make_forward_matches_forward_and_jax():
    cfg = make_config("transit", 1e30)
    for k, v in HYDRO.items():
        setattr(cfg, k, v)
    tm = make_forward_matches_jax(cfg, mode="fast")
    assert tm.hydrostatic and tm.solution == "transit"
