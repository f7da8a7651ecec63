"""The port's TransitModel in transit geometry in float32 against
transit_tpu's float32 model, on the two perturbed profiles of
tests/test_torch_transit_model.py: static and hydrostatic radii,
unbanded and bands=4; elementwise at 1e-4 (|a - b| / (|a| + 1e-6
max|a|), as tests/test_torch_banded_fine_f32.py)."""

import pytest
import torch

from tests.test_torch_transit_model import check_float32

torch.set_num_threads(1)


@pytest.mark.parametrize("bands", [0, 4])
@pytest.mark.parametrize("hydro", [False, True], ids=["static", "hydro"])
def test_float32_matches_jax_float32(hydro, bands):
    check_float32(hydro, bands)
