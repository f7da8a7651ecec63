"""The port's file formats and host odds and ends against the JAX
package's: the opacity-grid file (read, the memmap's wn_window, written
back byte for byte), the extinction savefile (@E@S@), the CLI's writers
(each writer's text byte for byte on the same arrays), Timers,
set_verbosity, resample and downsample (tests/test_aux.py:37-111,
tests/test_opacity_grid.py:27-55)."""

import os
import types

import numpy as np
import pytest
import torch

from tests.test_conformance import GOLD, make_config
from tests.test_torch_common import port_config
from transit_tpu import cli as jcli
from transit_tpu.numerics import resample as jresample
from transit_tpu.opacities import grid as jgrid
from transit_tpu.utils import savefiles as jsave
from transit_tpu_torch import cli
from transit_tpu_torch.model import TransitModel
from transit_tpu_torch.numerics.resample import downsample, resample
from transit_tpu_torch.opacities import grid
from transit_tpu_torch.utils.savefiles import load_extinction, save_extinction

torch.set_num_threads(1)

GRID = os.path.join(GOLD, "ref_opacity_grid.bin")
SAVE = os.path.join(GOLD, "ref_ext.save")
FIELDS = ("molID", "temp", "press", "wns", "grid")


@pytest.mark.parametrize("window", [None, (10, 60)])
def test_read_grid_equals_jax(window):
    got = grid.read_opacity_grid(GRID, wn_window=window)
    want = jgrid.read_opacity_grid(GRID, wn_window=window)
    for k in FIELDS:
        a, b = getattr(got, k), getattr(want, k)
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b)
    assert got.grid.shape == (20, 11, 1, 101 if window is None else 50)


def test_write_grid_gives_golden_bytes(tmp_path):
    p = tmp_path / "og.bin"
    grid.write_opacity_grid(str(p), grid.read_opacity_grid(GRID))
    with open(GRID, "rb") as f:
        assert p.read_bytes() == f.read()


def test_read_reference_saveext_as_jax():
    g = np.load(os.path.join(GOLD, "ref_eclipse_raddelt.npz"))
    nrad, nwn = g["ext"].shape
    ext, computed = load_extinction(SAVE, nrad, nwn)
    jext, jcomputed = jsave.load_extinction(SAVE, nrad, nwn)
    np.testing.assert_array_equal(ext, jext)
    np.testing.assert_array_equal(computed, jcomputed)
    assert computed.all()
    np.testing.assert_allclose(ext, g["ext"], rtol=1e-9)


@pytest.mark.parametrize("flags", [None, [1, 0, 1]])
def test_save_extinction_bytes_equal_jax(tmp_path, flags):
    ext = np.random.default_rng(1).standard_normal((3, 7))
    a, b = tmp_path / "port.save", tmp_path / "jax.save"
    save_extinction(str(a), ext, flags)
    jsave.save_extinction(str(b), ext, flags)
    assert a.read_bytes() == b.read_bytes()
    got = load_extinction(str(a), 3, 7)
    np.testing.assert_array_equal(got[0], ext)
    assert got[1].tolist() == ([True] * 3 if flags is None else
                               [True, False, True])


@pytest.mark.parametrize("raw", [b"NOTMAGIC" + b"\0" * 100,
                                 b"@E@S@" + b"\0" * 10])
def test_saveext_invalid_file_ignored(tmp_path, raw):
    p = tmp_path / "bad.save"
    p.write_bytes(raw)
    assert load_extinction(str(p), 4, 4) is None
    assert load_extinction(str(tmp_path / "absent.save"), 4, 4) is None


@pytest.fixture(scope="module")
def fixture_run():
    """The port's fast fixture model (float64, CPU) and its file
    atmosphere's result as numpy arrays."""
    m = TransitModel(port_config(make_config("eclipse", 1e30)), mode="fast",
                     dtype=torch.float64, device="cpu")
    res = m.compute()
    arrays = {k: cli._np(getattr(res, k)) for k in (
        "spectrum", "intensity", "tau", "last", "extinction", "cia",
        "scatt", "cloud", "total")}
    return m, types.SimpleNamespace(wns=res.wns, **arrays)


def _writes(tmp_path, monkeypatch, name, call):
    """The text each package's writer ``name`` writes through ``call``
    (writer, directory), run in a directory of its own."""
    out = {}
    for tag, mod in (("port", cli), ("jax", jcli)):
        d = tmp_path / tag
        d.mkdir()
        monkeypatch.chdir(d)
        call(getattr(mod, name), d)
        out[tag] = {p.name: p.read_bytes() for p in sorted(d.iterdir())}
    assert out["port"] and out["port"] == out["jax"]


@pytest.mark.parametrize("name", [
    "write_spectrum_eclipse", "write_spectrum_transit", "write_intensity",
    "write_toomuch", "write_2d", "write_2d_stream", "write_detail",
    "save_files", "write_sample_info"])
def test_writers_equal_jax(tmp_path, monkeypatch, fixture_run, name):
    m, r = fixture_run
    calls = {
        "write_spectrum_eclipse": ("write_spectrum", lambda w, d: w(
            "s.dat", r.wns, r.spectrum, "eclipse")),
        "write_spectrum_transit": ("write_spectrum", lambda w, d: w(
            "s.dat", r.wns, r.spectrum * 1e-7, "transit")),
        "write_intensity": ("write_intensity", lambda w, d: w(
            "i.dat", r.wns, r.intensity, m.angles)),
        "write_toomuch": ("write_toomuch", lambda w, d: w(
            "t.dat", r.wns, r.tau, r.last, m.rads_v, m.rfct)),
        "write_2d": ("write_2d", lambda w, d: w(
            "x.dat", "# header\n", r.wns, r.tau, "wavenumber:")),
        "write_2d_stream": ("write_2d_stream", lambda w, d: w(
            "x.dat", "# header\n", r.wns, r.total)),
        "write_detail": ("write_detail", lambda w, d: w(
            "x.dat:2040.5,2070,2100", r.wns, m.ips_v, r.tau, False)),
        "save_files": ("save_files", lambda w, d: w(r, m)),
        "write_sample_info": ("write_sample_info", lambda w, d: w(
            "sample.dat", m)),
    }
    writer, call = calls[name]
    _writes(tmp_path, monkeypatch, writer, call)


def test_timers_and_logging():
    from transit_tpu_torch.utils.log import Timers, logger, set_verbosity
    set_verbosity(5)
    assert logger.level == 10 and logger.handlers
    t = Timers()
    with t.stage("demo", sync=torch.zeros(1)):
        _ = sum(range(1000))
    with t.stage("cpu", sync="cpu"):
        pass
    rep = t.report()
    assert "demo" in rep and "cpu" in rep and "TOTAL" in rep
    assert [n for n, _ in t.records] == ["demo", "cpu"]
    set_verbosity(2)
    assert logger.level == 30


@pytest.mark.parametrize("scale", [1, 2, 3, 4, 7])
def test_downsample_matches_jax(scale):
    x = np.random.default_rng(scale).standard_normal(29)
    np.testing.assert_array_equal(downsample(x, scale),
                                  jresample.downsample(x, scale))
    np.testing.assert_array_equal(resample(x, scale),
                                  jresample.resample(x, scale))


def test_downsample_matches_reference_semantics():
    I = np.arange(7.0)
    np.testing.assert_allclose(downsample(I, 3), [(0 + 1) / 2.0,
                                                  (2 + 3 + 4) / 3.0,
                                                  (5 + 6) / 2.0])
    np.testing.assert_allclose(
        downsample(I, 2), [(0 + 0.5 * 1) / 1.5, (0.5 * 1 + 2 + 0.5 * 3) / 2.0,
                           (0.5 * 3 + 4 + 0.5 * 5) / 2.0, (5 + 0.5 * 6) / 1.5])
    np.testing.assert_allclose(resample(I, 3), [0, 3, 6])
