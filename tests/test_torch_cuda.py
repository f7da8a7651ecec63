"""The port's CUDA kernel on the card: marked ``cuda``, skipped without
one.  Imports no JAX, so it runs on a machine that has only PyTorch:

    python -m pytest -m cuda --noconftest tests/test_torch_cuda.py -q

(``--noconftest``: the suite's conftest.py imports JAX.)
"""

import os

import pytest
import torch

from transit_tpu_torch.config import TransitConfig
from transit_tpu_torch.model import TransitModel
from transit_tpu_torch.opacities.kernel_lbl import (kernel_extinction,
                                                    layer_tables,
                                                    line_tile_extinction,
                                                    plain_extinction)

torch.set_num_threads(1)

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _model(device, dtype=torch.float32):
    cfg = TransitConfig(
        atm=f"{FIX}/test.atm", linedb=f"{FIX}/test.tli",
        csfile=f"{FIX}/test_cia.dat", molfile=f"{FIX}/molecules.dat",
        wnlow=2000.0, wnhigh=2100.0, wndelt=1.0, wnosamp=216, wnfct=1.0,
        nwidth=20.0, ethreshold=1e-8, solution="eclipse", toomuch=1e30)
    return TransitModel(cfg, dtype=dtype, device=device)


def _state(m):
    t = m._t(m.atm.temp)
    return ((t * m.atm.tfct, m._t(m.atm.d), m.partition(t), m._molm_t,
             m._molrad_t),
            dict(wn_i=m.wns.i, dwn=m.wns.d, ethresh=m.cfg.ethreshold,
                 nwidth=m.cfg.nwidth))


@pytest.mark.cuda
def test_kernel_matches_plain_on_card(card):
    m = _model(card)
    args, kw = _state(m)
    before = line_tile_extinction.launches
    b = kernel_extinction(m.fplan, m.fdev, *args, **kw)
    a = plain_extinction(m.fplan, m.fdev, *args, **kw)
    torch.cuda.synchronize()
    assert line_tile_extinction.launches == before + 1
    rel = (a - b).abs() / (a.abs() + 1e-6 * a.abs().max())
    assert float(rel.max()) < 1e-5


@pytest.mark.cuda
def test_kernel_refuses_float64(card):
    m = _model(card, torch.float64)
    args, kw = _state(m)
    with pytest.raises(TypeError, match="float32"):
        kernel_extinction(m.fplan, m.fdev, *args, **kw)


@pytest.mark.cuda
def test_forward_through_kernel_on_card(card):
    m = _model(card)
    before = line_tile_extinction.launches
    s = m.forward(m.atm.temp, m.atm.q)
    m.use_kernel = False
    p = m.forward(m.atm.temp, m.atm.q)
    assert line_tile_extinction.launches == before + 1
    assert bool(torch.isfinite(s).all())
    assert float(((s - p).abs() / p.abs()).max()) < 1e-4


@pytest.mark.cuda
def test_zero_live_lines_on_card(card):
    m = _model(card)
    args, kw = _state(m)
    d = dict(m.fdev, mask=torch.zeros_like(m.fdev["mask"]))
    tab = layer_tables(d, *args)
    out = line_tile_extinction(m.fplan, d, tab, args[0], **kw)
    assert int(torch.count_nonzero(out)) == 0
