"""The port's ``make_forward`` on the banded plan (bands=4) against
transit_tpu's, float64 on the CPU (tests/test_torch_make_forward.py's
checks: rtol 1e-12 against the port's ``forward`` and JAX's
``make_forward()``, the gradient within 1e-9 of the max)."""

import torch

from tests.test_conformance import make_config
from tests.test_torch_make_forward import make_forward_matches_jax

torch.set_num_threads(1)


def test_banded_make_forward_matches_forward_and_jax():
    tm = make_forward_matches_jax(make_config("eclipse", 1e30), mode="fast",
                                  bands=4)
    assert tm.bplan is not None and len(tm.bplan.plans) >= 2
