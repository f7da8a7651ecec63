"""The port's CIA / cross-section converters
(transit_tpu_torch.tools.ciaformat) against transit_tpu.tools.ciaformat:
the inputs of tests/test_tools.py through both packages write the same
CS files byte for byte, and the port's reader reads them."""

import numpy as np
import pytest

from tests.test_tools import _write_xsc
from transit_tpu.tools import ciaformat as jcia
from transit_tpu_torch.io.crosssec import read_cross_section
from transit_tpu_torch.tools import ciaformat as pcia


def _both(tmp_path, fn):
    """fn(module, out path) for each package -> the two outputs' bytes."""
    out = []
    for name, mod in (("p", pcia), ("j", jcia)):
        path = str(tmp_path / f"{name}.dat")
        fn(mod, path)
        with open(path, "rb") as f:
            out.append(f.read())
    return out


def _borysow(tmp_path):
    temps = [400.0, 1000.0, 3000.0]
    src = tmp_path / "borysow.dat"
    lines = ["# Borysow-style table",
             "T(K):  " + "  ".join(f"{t:.0f}K" for t in temps)]
    wn = np.arange(100.0, 200.0, 10.0)
    vals = np.outer(wn, np.array(temps)) * 1e-9
    for i, w in enumerate(wn):
        lines.append(f"{w:10.2f} " + " ".join(f"{v:.5e}" for v in vals[i]))
    src.write_text("\n".join(lines) + "\n")
    return str(src)


def _hitran_cia(tmp_path):
    src = tmp_path / "H2-H2_2011.cia"
    wn = np.arange(20.0, 120.0, 20.0)
    with open(src, "w") as f:
        for t in (200.0, 400.0):
            f.write(f"H2-H2 {wn[0]:.1f} {wn[-1]:.1f} {len(wn)} {t:.1f} "
                    "2.0e-07 0.5\n")
            for w in wn:
                f.write(f" {w:.3f} {1e-8 * w * t / 1e4:.5e}\n")
    return str(src)


def _xsc(tmp_path, mol="CH4"):
    wn = np.linspace(1200.0, 1400.0, 27)
    files = []
    for t in (300.0, 500.0):
        p = tmp_path / f"{mol}_{t:.0f}K.xsc"
        _write_xsc(str(p), mol, 1200.0, 1400.0, 27, t,
                   1e-22 * (wn / 1000.0) * (t / 300.0))
        files.append(str(p))
    return files[::-1]


@pytest.mark.parametrize("kind", ["borysow", "hitran-cia", "hitran-xsc",
                                  "exomol", "merge"])
def test_converters_write_the_same_bytes(tmp_path, monkeypatch, kind):
    if kind == "borysow":
        src = _borysow(tmp_path)
        a, b = _both(tmp_path, lambda m, o: m.borysow_to_cs(src, o, "H2",
                                                            "He"))
    elif kind == "hitran-cia":
        src = _hitran_cia(tmp_path)
        a, b = _both(tmp_path, lambda m, o: m.hitran_cia_to_cs(src, o))
    elif kind == "hitran-xsc":
        files = _xsc(tmp_path)
        a, b = _both(tmp_path, lambda m, o: m.main(["hitran-xsc", *files,
                                                    o]))
    elif kind == "exomol":
        # The converter reads the temperature from the path's third "_"
        # field: relative names in the test's directory.
        monkeypatch.chdir(tmp_path)
        files = []
        for t in (500.0, 300.0):
            files.append(f"CH4_x_{t:.0f}K_0.sigma")
            np.savetxt(files[-1], np.c_[np.arange(10.0, 20.0), 1e-21 * t *
                                        np.arange(1.0, 11.0)])
        a, b = _both(tmp_path, lambda m, o: m.exomol_xsec_to_cs(files, o,
                                                                "CH4"))
    else:
        wn = np.arange(10.0, 50.0, 10.0)
        for name, temps in (("a.dat", [100.0, 200.0]), ("b.dat", [400.0])):
            pcia.write_cs(str(tmp_path / name), ["H2", "H2"],
                          np.array(temps),
                          wn, np.ones((wn.shape[0], len(temps))) * temps)
        a, b = _both(tmp_path, lambda m, o: m.merge_cs(
            str(tmp_path / "a.dat"), str(tmp_path / "b.dat"), o))
    assert a == b and len(a) > 0
    tb = read_cross_section(str(tmp_path / "p.dat"))
    assert np.all(np.isfinite(tb.cs)) and tb.cs.shape[0] == tb.wn.shape[0]


def test_read_spectrum_and_mismatch_equal_jax(tmp_path):
    p = tmp_path / "spec.dat"
    p.write_text("#wvl [um]      Flux\n5.0 10.0\n4.0 20.0\n")
    for got, want in zip(pcia.read_spectrum(str(p)),
                         jcia.read_spectrum(str(p))):
        np.testing.assert_array_equal(got, want)
    a, b = tmp_path / "a.xsc", tmp_path / "b.xsc"
    _write_xsc(str(a), "CH4", 100.0, 110.0, 11, 250.0, np.ones(11))
    _write_xsc(str(b), "CO2", 100.0, 110.0, 11, 300.0, np.ones(11))
    with pytest.raises(ValueError):
        pcia.hitran_xsc_to_cs([str(a), str(b)], str(tmp_path / "o"))
    assert pcia.main(["nope"]) == 1 and pcia.main([]) == 1
