"""tests/test_torch_sharded_grad.py's gradient check on the unbanded plan
(a file of its own: JAX compiles the gradient of its sharded step in
~5-10 s)."""

import torch

from tests.test_torch_sharded_grad import check_grad

torch.set_num_threads(1)


def test_sharded_grad_unbanded_matches_single_and_jax():
    check_grad(0)
