"""The port's gradient in T and q against jax.grad of the JAX model on
the 0.05 cm-1 hot-Jupiter slice (2000-2020 cm-1: decimated asym2 shells
at strides 2 and 4), float64, bands=6: the slow case of
tests/test_torch_grad_hj.py, in a file of its own (same data and bound)
so each file stays under 30 s."""

import pytest
import torch

from tests.test_torch_grad_hj import gradient_matches_jax

torch.set_num_threads(1)


@pytest.mark.parametrize("wndelt,wnlow,wnhigh", [(0.05, 2000.0, 2020.0)],
                         ids=["fine"])
def test_model_gradient_matches_jax_hot_jupiter_slice(wndelt, wnlow,
                                                      wnhigh):
    gradient_matches_jax(wndelt, wnlow, wnhigh)
