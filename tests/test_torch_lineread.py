"""The port's line-list compiler (transit_tpu_torch.lineread) against
transit_tpu.lineread: the inputs of tests/test_lineread.py and
tests/test_tips.py go through both packages; the readers' arrays are
equal, the TLI files byte for byte, the partition functions (TIPS and the
statistical-mechanical sources) value for value."""

import os

import numpy as np
import pytest

from tests.test_lineread import make_par_line
from transit_tpu.lineread import compile as jcompile
from transit_tpu.lineread import hitran as jhitran
from transit_tpu.lineread import kurucz as jkurucz
from transit_tpu.lineread import misc as jmisc
from transit_tpu.lineread import tips as jtips
from transit_tpu_torch.io.tli import read_tli, read_tli_band
from transit_tpu_torch.lineread import compile as pcompile
from transit_tpu_torch.lineread import hitran as phitran
from transit_tpu_torch.lineread import kurucz as pkurucz
from transit_tpu_torch.lineread import misc as pmisc
from transit_tpu_torch.lineread import tips as ptips
from transit_tpu_torch.lineread.base import load_isotopologues

PAR_ROWS = [
    (6, 1, 3030.0, 1e-20, 2.5, 100.0, 11.0),
    (6, 1, 3050.5, 2e-21, 1.0, 300.0, 9.0),
    (6, 2, 3040.25, 3e-22, 0.5, 50.0, 7.0),
    (6, 3, 3060.0, 4e-23, 0.25, 10.0, 5.0),
]


def _par(path, rows=PAR_ROWS):
    with open(path, "w") as f:
        for r in rows:
            f.write(make_par_line(*r))
    return str(path)


def _equal_arrays(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert np.asarray(x).dtype == np.asarray(y).dtype
        np.testing.assert_array_equal(x, y)


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def test_isotopologue_table_equals_jax():
    from transit_tpu.lineread.base import load_isotopologues as jload
    assert load_isotopologues() == jload()


def test_hitran_compile_byte_for_byte(tmp_path):
    """The .par of tests/test_lineread.py (and a 40-line one read in
    chunks) through each package's reader and compiler: equal arrays, the
    same TLI bytes, and the port's band read of it equal to the full
    read filtered."""
    path = _par(tmp_path / "06_test.par")
    for win in ((3.0, 3.4), (1e4 / 3055.0, 1e4 / 3035.0)):
        _equal_arrays(phitran.HitranReader(path).read(*win),
                      jhitran.HitranReader(path).read(*win))
    outs = []
    for name, rd, cp in (("p", phitran, pcompile), ("j", jhitran, jcompile)):
        out = str(tmp_path / f"{name}.tli")
        cp.compile_tli([rd.HitranReader(path).block(3.0, 3.4)], 3.0, 3.4,
                       out)
        outs.append(out)
    assert _bytes(outs[0]) == _bytes(outs[1])
    full = read_tli(outs[0])
    band = read_tli_band(outs[0], 1e4 / 3055.0, 1e4 / 3035.0)
    keep = (full.wl >= 1e4 / 3055.0) & (full.wl <= 1e4 / 3035.0)
    np.testing.assert_array_equal(band.wl, full.wl[keep])
    p = _par(tmp_path / "06_stream.par",
             [(6, 1 + i % 3, 2000.0 + 2.5 * i, 1e-20, 2.5, 100.0 + i, 11.0)
              for i in range(40)])
    r, j = phitran.HitranReader(p), jhitran.HitranReader(p)
    r.CHUNK_RECORDS = j.CHUNK_RECORDS = 7
    _equal_arrays(r.read(1e4 / 2070.0, 1e4 / 2010.0),
                  j.read(1e4 / 2070.0, 1e4 / 2010.0))


def test_compile_main_loads_the_ports_readers(tmp_path):
    """The CLI with a config file (-t hit, the default partition
    functions): the port's reader table names the port's modules, and
    the TLI equals JAX's byte for byte."""
    par = _par(tmp_path / "06_cli.par")
    assert all(v.startswith("transit_tpu_torch.lineread.")
               for v in pcompile.READERS.values())
    outs = []
    for name, cp in (("p", pcompile), ("j", jcompile)):
        cfg = tmp_path / f"{name}.cfg"
        out = str(tmp_path / f"{name}.tli")
        cfg.write_text(f"[Parameters]\ndb_list = {par}\ndbtype = hit\n"
                       f"iwav = 3.0\nfwav = 3.4\noutput = {out}\n")
        assert cp.main(["-c", str(cfg)]) == 0
        outs.append(out)
    assert _bytes(outs[0]) == _bytes(outs[1])
    assert type(pcompile._load_reader("ps", "x", None, None)) is \
        pkurucz.PandsReader


def test_pands_and_repack_readers_equal_jax(tmp_path):
    """The synthetic P&S binary and repack files of tests/test_lineread.py
    (:98-139): equal arrays and partition functions; the repack block
    compiles to the same bytes."""
    ratiolog = np.log(1 + 1 / 2e6)
    wl_nm = np.array([2500.0, 2600.0, 2700.0, 2800.0])
    rec = np.zeros(4, dtype=np.dtype([("iw", "<u4"), ("ielo", "<i2"),
                                      ("igf", "<i2")]))
    rec["iw"] = np.round(np.log(wl_nm) / ratiolog).astype(np.uint32)
    rec["ielo"] = [500, -700, 800, -900]
    rec["igf"] = [16000, 15000, -14000, -13000]
    ps = tmp_path / "ps.bin"
    rec.tofile(ps)
    _equal_arrays(pkurucz.PandsReader(str(ps)).read(2.0, 3.0),
                  jkurucz.PandsReader(str(ps)).read(2.0, 3.0))

    rec = np.zeros(5, dtype=np.dtype([("wn", "<f8"), ("elow", "<f8"),
                                      ("gf", "<f8"), ("iso", "<i4")]))
    rec["wn"] = [2000.0, 2100.0, 2200.0, 2300.0, 2400.0]
    rec["elow"] = [1, 2, 3, 4, 5]
    rec["gf"] = [1e-4, 1e-5, 1e-6, 1e-7, 1e-8]
    rec["iso"] = [21111, 21111, 31111, 21111, 31111]
    db = tmp_path / "CH4_repack_lbl.dat"
    rec.tofile(db)
    pf = tmp_path / "CH4_pf.dat"
    pf.write_text("# pf\n@ISOTOPES 21111 31111\n"
                  "100.0 10.0 11.0\n1000.0 100.0 110.0\n")
    r = pmisc.RepackReader(str(db), str(pf))
    j = jmisc.RepackReader(str(db), str(pf))
    win = (1e4 / 2350.0, 1e4 / 2050.0)
    _equal_arrays(r.read(*win), j.read(*win))
    _equal_arrays(r.partition(), j.partition())
    outs = [str(tmp_path / "p.tli"), str(tmp_path / "j.tli")]
    pcompile.compile_tli([r.block(*win)], *win, outs[0])
    jcompile.compile_tli([j.block(*win)], *win, outs[1])
    assert _bytes(outs[0]) == _bytes(outs[1])


@pytest.mark.parametrize("mol", sorted(jtips.MOL_CONST))
def test_statmech_partition_equals_jax(mol):
    """Every molecule of the statistical-mechanical table, its anchored
    isotopologues, on TIPS's temperature grid and at 296 K."""
    isos = sorted((jtips.MOL_CONST[mol].q296 or {"1": None}))
    for temps in (None, np.array([296.0, 1500.0])):
        _equal_arrays(ptips.statmech_source(mol, temps)(isos),
                      jtips.statmech_source(mol, temps)(isos))
    _equal_arrays(ptips.default_source(mol, isos)(isos),
                  jtips.default_source(mol, isos)(isos))


def test_other_partition_sources_equal_jax(tmp_path):
    """The rigid-rotor fallback, the Irwin polynomial (the VO reader's),
    and the tabulated text sources."""
    _equal_arrays(ptips.default_source("XYZ", ["1"])(["1"]),
                  jtips.default_source("XYZ", ["1"])(["1"]))
    coeffs = pmisc.VoplezReader.PFcoeffs
    _equal_arrays(ptips.polynomial_source(coeffs)(["16"]),
                  jtips.polynomial_source(coeffs)(["16"]))
    pf = tmp_path / "pf.dat"
    pf.write_text("# header\n# T 1 2\n100.0 10.0 11.0\n"
                  "1000.0 100.0 110.0\n")
    _equal_arrays(ptips.transit_pf_source(str(pf), 2, 1)(["1", "2"]),
                  jtips.transit_pf_source(str(pf), 2, 1)(["1", "2"]))
    assert os.path.exists(pf)
