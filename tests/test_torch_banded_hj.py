"""plain_banded_extinction against transit_tpu's fast.banded_extinction
on the hot-Jupiter files (benchmarks/data/hj: 100 layers, 4 isotopes)
at 0.05 cm-1, cut to 2000-2050 cm-1 (1001 wavenumbers) so that JAX's
CPU run stays short: band 0 keeps the full configuration's shells (a
stride-1 r2 shell with lanes="bins", decimated asym2 shells at strides 2
and 4 with lanes="lines"); float64."""

import numpy as np
import torch

from tests.test_torch_common import banded_pair, hotjupiter_config, rel

torch.set_num_threads(1)


def test_plain_banded_matches_jax_hot_jupiter_slice():
    cfg = hotjupiter_config(0.05)
    cfg.wnlow, cfg.wnhigh = 2000.0, 2050.0
    jm, ref, got = banded_pair(cfg, np.float64)
    shells = [(fp.wfn_tag, fp.lanes, s) for far in jm.bplan.far_plans
              if far for fp, _, s in far]
    assert shells[:3] == [("r2", "bins", 1), ("asym2", "lines", 2),
                          ("asym2", "lines", 4)]
    assert got.shape == ref.shape == (100, 1001)
    assert np.all(np.isfinite(got)) and got.max() > 0
    assert rel(ref, got) <= 1e-10
