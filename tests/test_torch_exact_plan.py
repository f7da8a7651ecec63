"""Exact mode's line plan of the port (opacities/lbl.py plan_lines and
device_arrays' isotope-run starts) equal to transit_tpu's field for
field, on the fixture line list and on the full hot-Jupiter list
(benchmarks/data/hj: 194,349 lines of 4 isotopes on the 0.5 cm-1 x 2160
grid; host only).  The port takes its native partition
(transit_tpu_torch/_native.py), JAX its Python loop or its own native
one, so the plans must agree either way."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_conformance import make_config
from tests.test_torch_common import hotjupiter_config
from transit_tpu import grids as jgrids
from transit_tpu.io.tli import read_tli as jread_tli
from transit_tpu.io.tli import select_lines as jselect
from transit_tpu.opacities import lbl as jlbl
from transit_tpu.opacities.voigt import ProfileTable as JTable
from transit_tpu_torch import grids
from transit_tpu_torch.constants import TLI_WAV_UNITS
from transit_tpu_torch.io.tli import read_tli, select_lines
from transit_tpu_torch.opacities import lbl

torch.set_num_threads(1)

CONFIGS = {"fixture": lambda: make_config("eclipse", 1e30),
           "hotjupiter": hotjupiter_config}


def _plans(cfg):
    """(JAX's plan, the port's plan) of cfg's line list, each package
    reading the file and building its own grids."""
    out = []
    for mk, rd, sel, pl in ((jgrids.make_wn_sampling, jread_tli, jselect,
                             jlbl.plan_lines),
                            (grids.make_wn_sampling, read_tli, select_lines,
                             lbl.plan_lines)):
        wns, owns = mk(wnlow=cfg.wnlow, wnhigh=cfg.wnhigh,
                       wndelt=cfg.wndelt, wnosamp=cfg.wnosamp,
                       wnfct=cfg.wnfct)
        wl, isoid, elow, gf = sel(rd(cfg.linedb), wns.i, wns.f)
        out.append(pl(wl, isoid, elow, gf, TLI_WAV_UNITS, wn_i=wns.i,
                      odwn=owns.d / owns.o, dwn=wns.d / wns.o,
                      owns_v=owns.v, n_coarse=wns.n, ofactor=owns.o))
    return out


@pytest.mark.parametrize("name", list(CONFIGS))
def test_plan_matches_jax(name):
    ref, got = _plans(CONFIGS[name]())
    assert got.n_groups < got.n_lines or name == "fixture"
    for f in dataclasses.fields(jlbl.LinePlan):
        a, b = getattr(got, f.name), getattr(ref, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name
    # The isotope-run start of each group, JAX's loop (lbl.py:280-282)
    # against the port's vectorised one:
    table = JTable(aDop=np.ones(1), aLor=np.ones(1),
                   profsize=np.ones((1, 1), np.int64),
                   base=np.zeros((1, 1), np.int64),
                   flat=np.ones(3, np.float32))
    niso = int(ref.isoid.max()) + 1
    iso = jlbl.IsoConst(mass=np.ones(niso), ratio=np.ones(niso),
                        imol=np.zeros(niso, np.int32),
                        iout=np.zeros(niso, np.int32), nmol_out=1)
    want = np.asarray(jlbl.device_arrays(ref, iso, table,
                                         dtype=jnp.float64)["g_iso_start"])
    np.testing.assert_array_equal(lbl.iso_run_start(got), want)
    assert len(np.unique(want)) == len(np.unique(ref.isoid))
