"""tests/test_torch_multihost.py's band check for a 3-process split (a
file of its own: JAX compiles each band's step in ~2-4 s)."""

import torch

from tests.test_torch_multihost import check_bands

torch.set_num_threads(1)


def test_band_models_match_jax_three_processes():
    check_bands(3)
