"""The port's CUDA kernels on the card: marked ``cuda``, skipped without
one.  Imports no JAX, so it runs on a machine that has only PyTorch:

    python -m pytest -m cuda --noconftest tests/test_torch_cuda.py -q

(``--noconftest``: the suite's conftest.py imports JAX.)
"""

import os

import pytest
import torch

from transit_tpu_torch.config import TransitConfig
from transit_tpu_torch.model import TransitModel
from transit_tpu_torch.opacities import fast
from transit_tpu_torch.opacities.kernel_lbl import (
    kernel_extinction, layer_kmax, layer_tables, line_tile_extinction,
    plain_extinction, plain_kmax, run_counts, strength_coef)

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


def _kernel_vs_plain(m, args, kw):
    """Kernel and plain version on the same state: max relative error
    (the bound of tests/test_pallas.py:35) and the kernel's counters
    against the host count of its design (run_counts)."""
    before = (line_tile_extinction.launches, layer_kmax.launches)
    b = kernel_extinction(m.fplan, m.fdev, *args, **kw)
    a = plain_extinction(m.fplan, m.fdev, *args, **kw)
    assert (line_tile_extinction.launches, layer_kmax.launches) == \
        (before[0] + 1, before[1] + 1)
    tab = layer_tables(m.fdev, *args)
    stats = torch.zeros(3, dtype=torch.int64, device=a.device)
    c = line_tile_extinction(m.fplan, m.fdev, tab, args[0], **kw,
                             stats=stats)
    torch.cuda.synchronize()
    assert torch.equal(b, c)
    host = run_counts(m.fplan, m.fdev, tab, args[0], **kw)
    assert dict(zip(("chains", "live", "pairs"), stats.tolist())) == host
    assert b.shape == a.shape == (args[0].shape[0], m.wns.n)
    rel = (a - b).abs() / (a.abs() + 1e-6 * a.abs().max())
    return float(rel.max()) if a.numel() else 0.0, host


@pytest.mark.cuda
def test_layer_kmax_equals_plain_bitwise(card):
    m = _model(card)
    args, _ = _state(m)
    coef0 = strength_coef(m.fdev, args[2])
    before = layer_kmax.launches
    got = layer_kmax(m.fdev, args[0], coef0)
    want = plain_kmax(m.fdev, args[0], coef0)
    torch.cuda.synchronize()
    assert layer_kmax.launches == before + 1
    assert torch.isfinite(want).all() and torch.equal(got, want)


@pytest.mark.cuda
def test_kernel_wide_wing_in_rounds(card):
    """A wing far wider than the plan's halo: every kept line covers its
    whole tile, so a chunk holds more (bin, line) pairs than one round
    of shared memory (20 layers x 96 lines x 8 bins > 4096)."""
    m = _model(card)
    args, kw = _state(m)
    kw["nwidth"] = 1e5
    rel, host = _kernel_vs_plain(m, args, kw)
    assert rel < 1e-5
    assert host["pairs"] == host["live"] * m.fplan.tw


@pytest.mark.cuda
def test_kernel_ragged_layer_count(card):
    m = _model(card)
    (T, dens, Z, mm, mr), kw = _state(m)
    rel, host = _kernel_vs_plain(m, (T[:7], dens[:, :7], Z[:, :7], mm, mr),
                                 kw)
    assert rel < 1e-5 and host["pairs"] > 0


@pytest.mark.cuda
def test_kernel_every_line_cut_by_ethresh(card):
    """ethresh above 1 drops every line (k0 < ethresh * kmax)."""
    m = _model(card)
    args, kw = _state(m)
    kw["ethresh"] = 2.0
    out = kernel_extinction(m.fplan, m.fdev, *args, **kw)
    assert int(torch.count_nonzero(out)) == 0
    tab = layer_tables(m.fdev, *args)
    assert run_counts(m.fplan, m.fdev, tab, args[0], **kw)["live"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("tw", [64, 256])
def test_kernel_wide_tiles(card, tw):
    """Other tile widths than the fixture's 8: fewer layers per block,
    longer chunks, and (tw 256) one ragged tile of 101 bins."""
    m = _model(card)
    p = m.fplan
    mw = fast.max_width_bound(m.atm, m.mol, m.iso.mass, m.wns.f,
                              m.iso.imol)
    m.fplan = fast.make_fast_plan(p.wavn, p.isoid, p.elow, p.gf,
                                  wn_i=m.wns.i, dwn=m.wns.d,
                                  n_coarse=m.wns.n, max_width=mw,
                                  nwidth=m.cfg.nwidth, tw=tw)
    m.fdev = {**m.fdev, **fast.fast_device_arrays(m.fplan, m.iso,
                                                  dtype=torch.float32,
                                                  device=card)}
    args, kw = _state(m)
    rel, host = _kernel_vs_plain(m, args, kw)
    assert rel < 1e-5 and host["pairs"] > 0
