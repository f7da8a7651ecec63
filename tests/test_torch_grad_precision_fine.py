"""The Voigt pair's precision in the backward on the 0.05 cm-1
hot-Jupiter slice (2000-2020 cm-1, bands=6: decimated asym2 shells at
strides 2 and 4 beside the near tiles and the stride-1 r2 shell), against
jax.grad in float64 and in float32 (the port's side computed once for
both); the study and its bounds are test_torch_grad_precision_main.py's;
and the port's float64 gradient against the same float64 JAX
gradient."""

import pytest
import torch

from tests.test_torch_grad_precision_main import (check_study,
                                                  gradient_matches_jax,
                                                  precision_study)

torch.set_num_threads(1)

FINE = (0.05, 2000.0, 2020.0)


def test_float32_pair_fine_slice():
    check_study(precision_study(*FINE, jax_refs=("jax64",)))


@pytest.mark.parametrize("wndelt,wnlow,wnhigh", [FINE], ids=["fine"])
def test_model_gradient_matches_jax_hot_jupiter_slice(wndelt, wnlow,
                                                      wnhigh):
    """The port's float64 gradient against JAX's on this slice
    (test_torch_grad_precision_main.gradient_matches_jax), sharing the
    study's JAX gradient."""
    gradient_matches_jax(wndelt, wnlow, wnhigh)


def test_float32_pair_fine_slice_vs_jax_f32():
    check_study(precision_study(*FINE, jax_refs=("jax32",)))
