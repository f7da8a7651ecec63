"""The port's CLI (transit_tpu_torch/cli.py) on tests/test_cli.py's
configuration, float64 on the CPU, against the reference C goldens at
that file's tolerances (spectrum, intensities, --savefiles dumps,
outtoomuch, outsample) and ref_detail.npz (tests/test_conformance.py:
183-220; tau, extinction and CIA do not depend on the ray grid); the
opacity modes of tests/test_opacity_grid.py:141-200 (mode (b): one run
builds the grid, writes it and carries on; its grid and spectrum bytes
equal the two-step path's, the plain versions being deterministic);
flags over the file; ``python -m transit_tpu_torch.cli`` (run as
__main__); no device and no card raises.  One profile table for the
module: every model here has the same table axes."""

import functools
import os
import runpy
import sys

import numpy as np
import pytest
import torch

from tests.make_golden_spectrum import parse_2d_file, parse_spectrum
from tests.test_cli import CFG
from tests.test_conformance import FIX, GOLD
from transit_tpu_torch import cli
from transit_tpu_torch import model as model_mod

torch.set_num_threads(1)

DETAIL = {"detailtau": ("dtau.dat", "2040.5,2070"),
          "detailext": ("dext.dat", "2025,2050"),
          "detailcia": ("dcia.dat", "2060")}


@pytest.fixture(scope="module", autouse=True)
def one_table():
    """The models of this module build their profile table once (the
    same arguments give the same table)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(model_mod, "build_profile_table",
                   functools.cache(model_mod.build_profile_table))
        yield


def run(argv, cwd):
    """cli.main on the CPU in float64, in ``cwd`` (--savefiles writes
    there)."""
    old = os.getcwd()
    os.chdir(cwd)
    try:
        return cli.main(argv, device="cpu", dtype=torch.float64)
    finally:
        os.chdir(old)


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    outdir = tmp_path_factory.mktemp("cli")
    cfgpath = outdir / "run.cfg"
    cfgpath.write_text(
        CFG.format(fix=FIX) +
        f"outspec {outdir}/spec.dat\n"
        f"outtoomuch {outdir}/toomuch.dat\n"
        f"outintens {outdir}/intens.dat\n"
        f"outsample {outdir}/sample.dat\n" +
        "".join(f"{k} {outdir}/{f}:{w}\n" for k, (f, w) in DETAIL.items()))
    assert run(["-c", str(cfgpath)], outdir) == 0
    return outdir


def test_cli_spectrum(cli_run):
    g = np.load(os.path.join(GOLD, "ref_eclipse.npz"))
    wl, spec = parse_spectrum(cli_run / "spec.dat")
    np.testing.assert_allclose(spec, g["spec"], rtol=1e-5)
    np.testing.assert_allclose(wl, g["wl"], rtol=1e-9)


def test_cli_savefiles(cli_run):
    g = np.load(os.path.join(GOLD, "ref_eclipse.npz"))
    _, tau = parse_2d_file(cli_run / "tau.dat")
    np.testing.assert_allclose(tau, g["tau"], rtol=5e-5,
                               atol=g["tau"].max() * 1e-10)
    _, cia = parse_2d_file(cli_run / "CIA.dat")
    np.testing.assert_allclose(cia, g["cia"], rtol=1e-7,
                               atol=abs(g["cia"]).max() * 1e-9)
    _, ext = parse_2d_file(cli_run / "mol_extion.dat", tag="radius:")
    np.testing.assert_allclose(ext, g["ext"], rtol=5e-5,
                               atol=g["ext"].max() * 1e-10)


def test_cli_savefiles_extinction_dumps(cli_run):
    g = np.load(os.path.join(GOLD, "ref_eclipse.npz"))
    _, total = parse_2d_file(cli_run / "total_extion.dat")
    _, cloud = parse_2d_file(cli_run / "cloud_extion.dat")
    _, scatt = parse_2d_file(cli_run / "scatt_extion.dat")
    expect = g["ext"].T + g["cia"]
    np.testing.assert_allclose(total, expect, rtol=5e-5,
                               atol=abs(expect).max() * 1e-9)
    assert np.all(cloud == 0.0) and cloud.shape == total.shape
    assert np.all(scatt == 0.0) and scatt.shape == total.shape
    head = (cli_run / "total_extion.dat").read_text()[:60]
    assert head.startswith("\n# 2D total extinction\n")


def test_cli_intensity_and_toomuch(cli_run):
    g = np.load(os.path.join(GOLD, "ref_eclipse.npz"))
    d = np.loadtxt(cli_run / "intens.dat")
    np.testing.assert_allclose(d[:, 1:], g["intens"][:, 1:], rtol=1e-5)
    t = np.loadtxt(cli_run / "toomuch.dat", skiprows=2)
    assert t.shape == (g["spec"].shape[0], 4) and np.all(t[:, 1] > 0)


def test_cli_outsample_blocks(cli_run):
    text = (cli_run / "sample.dat").read_text()
    blocks = text.split("############################\n")[1:]
    assert [b.split("\n")[0] for b in blocks] == [
        f"   {name:<12} Sampling" for name in (
            "Wavenumber", "Wavelength", "Radius", "Impact parameter")]
    rad = next(b for b in blocks if b.startswith("   Radius"))
    ip = next(b for b in blocks if b.startswith("   Impact"))
    rv = np.array([float(v) for v in rad.split("Values:")[1].split()])
    iv = np.array([float(v) for v in ip.split("Values:")[1].split()])
    assert len(rv) == len(iv) > 1
    np.testing.assert_allclose(iv, rv[::-1], rtol=1e-6)
    assert "Oversample" not in rad and "Oversample: 0" in ip


def test_cli_detail_outputs(cli_run):
    g = np.load(os.path.join(GOLD, "ref_detail.npz"))

    def read(name):
        path = cli_run / DETAIL[name][0]
        with open(path) as f:
            head = f.readline().split("=>")[1].split()
        return (np.array([float(v) for v in head]),
                np.loadtxt(path, skiprows=1))

    wn_t, dt = read("detailtau")
    np.testing.assert_allclose(wn_t, g["dtau_wn"])
    np.testing.assert_allclose(dt, g["dtau"], rtol=1e-5)
    wn_e, de = read("detailext")
    np.testing.assert_allclose(wn_e, g["dext_wn"])
    np.testing.assert_allclose(de, g["dext"], rtol=5e-5,
                               atol=g["dext"].max() * 1e-10)
    # The reference's CIA column is its float reading of a double array
    # (tests/test_conformance.py:206-212): only the selection column.
    wn_c, dc = read("detailcia")
    np.testing.assert_allclose(wn_c, g["dcia_wn"])
    np.testing.assert_allclose(dc[:, 0], g["dcia"][:, 0], rtol=1e-6)


def test_cli_flag_overrides(tmp_path):
    cfgpath = tmp_path / "c.cfg"
    cfgpath.write_text("toomuch 5\nsolution eclipse\nwnlow 2000\n")
    cfg, mode, bands = cli.config_from_args(
        ["-c", str(cfgpath), "--toomuch", "9", "--solution", "transit",
         "--mode", "fast", "--bands", "6", "--ethresh", "1e-6"])
    assert (cfg.toomuch, cfg.solution, cfg.wnlow, cfg.ethreshold) == (
        9.0, "transit", 2000.0, 1e-6)
    assert (mode, bands) == ("fast", 6)
    assert cli.build_parser().parse_args(["--device", "cpu"]).device == "cpu"


COMMON = [
    "--atm", f"{FIX}/test.atm", "--linedb", f"{FIX}/test.tli",
    "--csfile", f"{FIX}/test_cia.dat", "--molfile", f"{FIX}/molecules.dat",
    "--wnlow", "2000", "--wnhigh", "2100", "--wndelt", "1.0",
    "--wnosamp", "216", "--wnfct", "1.0", "--ndop", "15", "--nlor", "15",
    "--dmin", "1e-3", "--dmax", "0.25", "--lmin", "1e-4", "--lmax", "10.0",
    "--nwidth", "20", "--ethresh", "1e-8", "--solution", "eclipse",
    "--toomuch", "1e30", "--raygrid", "0 20 40 60 80", "--tlow", "1000",
    "--thigh", "2000", "--tempdelt", "100", "--verb", "0"]


@pytest.mark.parametrize("mode", ["exact", "fast"])
def test_mode_b_build_and_continue(tmp_path, mode):
    """Mode (b): an absent opacityfile is built, written, and serves the
    spectrum in the same run; its bytes equal the two-step path's
    (--justOpacity, then a grid-mode run), and the spectrum too; the
    exact grid is the C golden's within tests/test_opacity_grid.py:44's
    tolerances."""
    from transit_tpu_torch.opacities.grid import read_opacity_grid
    common = COMMON + ["--mode", mode]
    grid2, spec2 = tmp_path / "two_step.bin", tmp_path / "two_step.dat"
    assert run(common + ["--opacityfile", str(grid2), "--justOpacity"],
               tmp_path) == 0
    assert grid2.exists() and not spec2.exists()
    assert run(common + ["--opacityfile", str(grid2), "--outspec",
                         str(spec2)], tmp_path) == 0
    gridb, specb = tmp_path / "mode_b.bin", tmp_path / "mode_b.dat"
    assert run(common + ["--opacityfile", str(gridb), "--outspec",
                         str(specb)], tmp_path) == 0
    assert gridb.read_bytes() == grid2.read_bytes()
    assert specb.read_bytes() == spec2.read_bytes()
    if mode == "exact":
        ref = read_opacity_grid(os.path.join(GOLD, "ref_opacity_grid.bin"))
        np.testing.assert_allclose(read_opacity_grid(str(gridb)).grid,
                                   ref.grid, rtol=5e-5,
                                   atol=ref.grid.max() * 1e-10)


def test_cli_module_entry_point(tmp_path, monkeypatch):
    """``python -m transit_tpu_torch.cli`` (the module run as __main__,
    here in this interpreter) with --device cpu (float32, the model's
    default) exits 0 and writes the spectrum that main() writes."""
    args = COMMON + ["--mode", "fast", "--device", "cpu"]
    monkeypatch.chdir(tmp_path)
    monkeypatch.delitem(sys.modules, "transit_tpu_torch.cli")
    monkeypatch.setattr(sys, "argv", ["transit_tpu_torch.cli", *args,
                                      "--outspec", str(tmp_path / "a.dat")])
    with pytest.raises(SystemExit) as done:
        runpy.run_module("transit_tpu_torch.cli", run_name="__main__")
    assert done.value.code == 0
    assert cli.main(args + ["--outspec", str(tmp_path / "b.dat")]) == 0
    a = (tmp_path / "a.dat").read_bytes()
    assert a == (tmp_path / "b.dat").read_bytes() and len(a) > 1000


def test_cli_without_device_or_card_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(COMMON + ["--mode", "fast", "--outspec",
                           str(tmp_path / "s.dat")])
