"""The line-tile module of the port (opacities/fast.py planner,
opacities/kernel_lbl.py, convert.py) against transit_tpu: the same plan
and the same tile tensors.  plain_extinction against the Pallas kernel
in interpret mode is in tests/test_torch_pallas_f64.py and
tests/test_torch_pallas_f32.py (one case each, so that each file stays
short on its test worker)."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from tests.test_conformance import make_config
from transit_tpu.config import TransitConfig as JConfig
from transit_tpu.model import TransitModel as JModel
from transit_tpu_torch.config import TransitConfig
from transit_tpu_torch.convert import device_arrays_from_numpy
from transit_tpu_torch.model import TransitModel
from transit_tpu_torch.opacities import _build, fast, kernel_lbl
from transit_tpu_torch.opacities.kernel_lbl import (bin_runs,
                                                    kernel_extinction,
                                                    layer_kmax,
                                                    layer_tables,
                                                    line_tile_extinction,
                                                    plain_extinction,
                                                    _tile_chunks)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "benchmarks", "data")


def _bench_config():
    return JConfig(
        atm=f"{DATA}/bench.atm", linedb=f"{DATA}/bench.tli",
        csfile=f"{DATA}/bench_cia.dat", molfile=f"{DATA}/molecules.dat",
        wnlow=2000.0, wnhigh=2500.0, wndelt=0.25, wnosamp=216, wnfct=1.0,
        nwidth=20.0, ethreshold=1e-8, solution="eclipse", toomuch=1e30)


def _pair(jcfg, dtype=torch.float64):
    """JAX fast model (f64) and the port's model on the CPU."""
    jm = JModel(jcfg, mode="fast")
    tm = TransitModel(TransitConfig(**dataclasses.asdict(jcfg)),
                      dtype=dtype, device="cpu")
    return jm, tm


@pytest.fixture(scope="module")
def fixture_pair():
    return _pair(make_config("eclipse", 1e30))


def _state(m, dtype):
    """(temps_cgs, densities, Z, mol_mass, mol_radius, kw) of the file
    atmosphere as numpy arrays in ``dtype``."""
    a = lambda v: np.asarray(v, dtype=dtype)
    kw = dict(wn_i=m.wns.i, dwn=m.wns.d, ethresh=m.cfg.ethreshold,
              nwidth=m.cfg.nwidth)
    return (a(m.atm.temp * m.atm.tfct), a(m.atm.d), a(m.Z_layers),
            a(m.mol.mass), a(m.mol.radius)), kw


def _np_fdev(jm, dtype):
    return {k: (np.asarray(v, dtype=dtype)
                if np.asarray(v).dtype == np.float64 else np.asarray(v))
            for k, v in jm.fdev.items()}


def _plan_fields_equal(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and np.array_equal(x, y), f.name
        else:
            assert x == y, f.name


def test_plan_equals_jax_fixture(fixture_pair):
    jm, tm = fixture_pair
    _plan_fields_equal(jm.fplan, tm.fplan)


def test_plan_equals_jax_bench():
    jm, tm = _pair(_bench_config())
    assert tm.fplan.ntiles > 100
    _plan_fields_equal(jm.fplan, tm.fplan)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_device_arrays_from_numpy(fixture_pair, dtype):
    jm, _ = fixture_pair
    npdt = np.float64 if dtype == torch.float64 else np.float32
    tm = TransitModel(TransitConfig(**dataclasses.asdict(jm.cfg)),
                      dtype=dtype, device="cpu")
    conv = device_arrays_from_numpy(_np_fdev(jm, npdt), dtype=dtype,
                                    device="cpu")
    assert conv.keys() == tm.fdev.keys()
    for k, v in tm.fdev.items():
        assert conv[k].dtype == v.dtype, k
        assert torch.equal(conv[k], v), k


def _rel(a, b):
    return np.max(np.abs(a - b) / (np.abs(a) + 1e-6 * np.abs(a).max()))


def test_plain_ragged_layer_subsets(fixture_pair):
    """Any layer count gives the rows of the full run: each layer's
    extinction depends only on its own state and the kmax scan."""
    jm, tm = fixture_pair
    args, kw = _state(jm, np.float64)
    T, dens, Z, mm, mr = (torch.as_tensor(a) for a in args)
    full = plain_extinction(tm.fplan, tm.fdev, T, dens, Z, mm, mr, **kw)
    for sl in (slice(0, 1), slice(3, 16)):
        part = plain_extinction(tm.fplan, tm.fdev, T[sl], dens[:, sl],
                                Z[:, sl], mm, mr, **kw)
        assert part.shape == (sl.stop - sl.start, tm.wns.n)
        torch.testing.assert_close(part, full[sl], rtol=1e-14, atol=0)


def test_plain_zero_lines(fixture_pair):
    """No live line in any tile (every mask off) -> exactly zero."""
    _, tm = fixture_pair
    args, kw = _state(tm, np.float64)
    d = dict(tm.fdev, mask=torch.zeros_like(tm.fdev["mask"]))
    out = plain_extinction(tm.fplan, d, *(torch.as_tensor(a) for a in args),
                           **kw)
    assert out.shape == (20, tm.wns.n)
    assert torch.count_nonzero(out) == 0


def test_cpu_tensors_never_touch_the_cuda_build(fixture_pair, monkeypatch):
    _, tm = fixture_pair

    def refuse(*a, **k):
        raise AssertionError("CPU tensors reached the CUDA build")
    monkeypatch.setattr(_build, "build", refuse)
    monkeypatch.setattr(_build, "load_library", refuse)
    args, kw = _state(tm, np.float64)
    targs = [torch.as_tensor(a) for a in args]
    before = (kernel_lbl.line_tile_extinction.launches,
              kernel_lbl.layer_kmax.launches)
    got = kernel_extinction(tm.fplan, tm.fdev, *targs, **kw)
    want = plain_extinction(tm.fplan, tm.fdev, *targs, **kw)
    assert torch.equal(got, want)
    assert (kernel_lbl.line_tile_extinction.launches,
            kernel_lbl.layer_kmax.launches) == before


@pytest.mark.parametrize("case,dtype,tw", [("fixture", torch.float32, None),
                                           ("fixture", torch.float64, None),
                                           ("fixture", torch.float32, 64),
                                           ("bench", torch.float32, None)])
def test_bin_runs_mark_exactly_the_used_bins(case, dtype, tw):
    """The kernel's design (csrc/line_tile.cu:find_run, as bin_runs
    computes it on the host): each live (layer, tile, line)'s run
    [b0, b1] covers exactly the bins that the plain version's ``use``
    mask marks — a kept line inside its wing — and no other.  ``tw``
    replans the tiles at that width (the planner's own is 8 here)."""
    jcfg = make_config("eclipse", 1e30) if case == "fixture" \
        else _bench_config()
    m = TransitModel(TransitConfig(**dataclasses.asdict(jcfg)), dtype=dtype,
                     device="cpu")
    if tw is not None:
        p = m.fplan
        mw = fast.max_width_bound(m.atm, m.mol, m.iso.mass, m.wns.f,
                                  m.iso.imol)
        m.fplan = fast.make_fast_plan(p.wavn, p.isoid, p.elow, p.gf,
                                      wn_i=m.wns.i, dwn=m.wns.d,
                                      n_coarse=m.wns.n, max_width=mw,
                                      nwidth=m.cfg.nwidth, tw=tw)
        m.fdev = {**m.fdev, **fast.fast_device_arrays(
            m.fplan, m.iso, dtype=dtype, device="cpu")}
        assert m.fplan.tw == tw
    args, kw = _state(m, np.float64)
    targs = [torch.as_tensor(a).to(dtype) for a in args]
    tab = layer_tables(m.fdev, *targs)
    bins = torch.arange(m.fplan.tw)[None, None, :, None]
    npairs = 0
    for (t0, t1, b0, b1, _, live), (s0, s1, *_, use) in zip(
            bin_runs(m.fplan, m.fdev, tab, targs[0], **kw),
            _tile_chunks(m.fplan, m.fdev, tab, targs[0], **kw)):
        assert (t0, t1) == (s0, s1)
        marks = (live[:, :, None, :] & (bins >= b0[:, :, None, :]) &
                 (bins <= b1[:, :, None, :]))
        assert torch.equal(marks, use)
        npairs += int(use.sum())
    assert npairs > 0


def test_kernel_wrappers_refuse_cpu_tensors(fixture_pair):
    _, tm = fixture_pair
    args, kw = _state(tm, np.float32)
    tm32 = TransitModel(tm.cfg, dtype=torch.float32, device="cpu")
    targs = [torch.as_tensor(a) for a in args]
    tab = layer_tables(tm32.fdev, *targs)
    with pytest.raises(ValueError, match="CUDA"):
        layer_kmax(tm32.fdev, targs[0], tab["coef0"])
    with pytest.raises(ValueError, match="CUDA"):
        line_tile_extinction(tm32.fplan, tm32.fdev, tab, targs[0], **kw)
