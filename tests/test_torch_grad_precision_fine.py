"""The Voigt pair's precision in the backward on the 0.05 cm-1
hot-Jupiter slice (2000-2020 cm-1, bands=6: decimated asym2 shells at
strides 2 and 4 beside the near tiles and the stride-1 r2 shell), against
jax.grad in float64 (in float32: test_torch_grad_precision_fine_f32.py,
so that each file stays under 30 s); the study and its bounds are
test_torch_grad_precision_main.py's."""

import torch

from tests.test_torch_grad_precision_main import check_study, precision_study

torch.set_num_threads(1)

FINE = (0.05, 2000.0, 2020.0)


def test_float32_pair_fine_slice():
    check_study(precision_study(*FINE, jax_refs=("jax64",)))
