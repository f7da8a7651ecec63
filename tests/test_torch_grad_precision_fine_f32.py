"""The Voigt pair's precision in the backward on the 0.05 cm-1
hot-Jupiter slice against jax.grad in float32 (in float64:
test_torch_grad_precision_fine.py); the study and its bounds are
test_torch_grad_precision_main.py's."""

import torch

from tests.test_torch_grad_precision_fine import FINE
from tests.test_torch_grad_precision_main import check_study, precision_study

torch.set_num_threads(1)


def test_float32_pair_fine_slice_vs_jax_f32():
    check_study(precision_study(*FINE, jax_refs=("jax32",)))
