"""Part 2 of the port's conformance profile table against transit_tpu's
(tests/test_torch_exact_voigt.py's check_table_part: within 1 float32
ulp), in a file of its own so each file stays under 30 s."""

import torch

from tests.test_torch_exact_voigt import check_table_part

torch.set_num_threads(1)


def test_profile_table_part_matches_jax():
    check_table_part(2)
