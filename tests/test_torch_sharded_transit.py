"""The port's sharded transit spectrum against JAX's sharded step and the
port's single model (tests/test_torch_sharded.py's check, in a file of
its own: JAX compiles each sharded step in ~3-5 s)."""

import pytest
import torch

from tests.test_torch_sharded import check_spectrum

torch.set_num_threads(1)


@pytest.mark.parametrize("bands,rtol", [(0, 1e-11), (6, 1e-10)])
def test_sharded_transit_matches_jax_and_single(bands, rtol):
    check_spectrum("transit", bands, rtol)
