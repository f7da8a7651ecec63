"""plain_banded_extinction against transit_tpu's fast.banded_extinction
on the fine-grid configuration (tests/test_fast_and_forward.py:261: 4001
wavenumbers at 0.01 cm-1, 20 layers, bands=6), whose plan has tile
widths up to 512, decimated asym2 shells at strides 2-16 with
lanes="bins" and tile classes, and a stride-1 r2 shell; np.float64, far_full_res=False."""

import numpy as np
import torch

from tests.test_torch_common import banded_pair, fine_grid_config, rel

torch.set_num_threads(1)


def test_plain_banded_matches_jax_fine_grid_f64():
    jm, ref, got = banded_pair(fine_grid_config(), np.float64,
                               far_full_res=False)
    strides = [s for far in jm.bplan.far_plans if far for *_, s in far]
    assert max(strides) >= 4
    assert got.shape == ref.shape == (20, 4001) and got.dtype == np.float64
    assert np.all(np.isfinite(got)) and got.max() > 0
    assert rel(ref, got) <= 1e-10
