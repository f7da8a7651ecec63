"""The eclipse path weights of the port (rt/geometry.py
eclipse_weights_torch) against transit_tpu's, values and gradient: a
case of tests/test_torch_geometry.py's test_weights_match_jax, in a file
of its own (same data and bounds) so each file stays under 30 s."""

import pytest
import torch

from tests.test_torch_geometry import weights_match_jax

torch.set_num_threads(1)


@pytest.mark.parametrize("name", ["eclipse"])
def test_weights_match_jax(name):
    weights_match_jax(name)
