"""The port's ``make_forward`` in exact mode (the default) against
transit_tpu's, float64 on the CPU, on the conformance fixture's
2000-2040 cm-1 (the JAX profile table builds in half the time of the
whole fixture's; tests/test_torch_exact_grad.py), the port's model on
JAX's profile table: rtol 1e-12 against the port's ``forward`` and
JAX's ``make_forward()``, the gradient within 1e-9 of the max
(tests/test_torch_make_forward.py)."""

import torch

from tests.test_conformance import make_config
from tests.test_torch_make_forward import make_forward_matches_jax

torch.set_num_threads(1)


def test_exact_make_forward_matches_forward_and_jax():
    cfg = make_config("eclipse", 1e30)
    cfg.wnhigh = 2040.0
    tm = make_forward_matches_jax(cfg, jax_table=True)
    assert tm.mode == "exact" and tm.plan is not None
