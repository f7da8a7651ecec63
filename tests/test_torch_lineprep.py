"""The port's native host preprocessing (transit_tpu_torch/_native.py,
csrc/lineprep.cpp) bit for bit against the JAX package's functions on
seeded inputs, and against the port's own plain versions.
transit_tpu._native is not built here (tests/test_native.py skips), so
the JAX package runs its Python paths: the co-add loop of
``plan_lines``, ``np.lexsort`` and ``float()``.  Host only; no JAX
program is compiled."""

import dataclasses
import locale

import numpy as np
import pytest
import torch

from transit_tpu.lineread.compile import sort_iso_wl as jsort_iso_wl
from transit_tpu.lineread.hitran import _parse_float as jparse_float
from transit_tpu.opacities import lbl as jlbl
from transit_tpu_torch import _native
from transit_tpu_torch.lineread import compile as pcompile
from transit_tpu_torch.lineread import hitran as phitran
from transit_tpu_torch.opacities import _build, lbl

torch.set_num_threads(1)

# The partition's grid: exact binary steps, so that lines can sit exactly
# half-way between two oversampled bins.
WN_I, ODWN, DWN, OFACTOR = 100.0, 0.25, 1.0, 4
OWNS = WN_I + ODWN * np.arange(401)          # 100 .. 200 cm-1
WFCT = 1.0


def _wl_of(wn: np.ndarray) -> np.ndarray:
    """Wavelengths whose 1 / (wl * WFCT) is ``wn`` exactly where a double
    within 8 ulps of 1 / wn gives it back, else 1 / wn."""
    wl = 1.0 / (wn * WFCT)
    for _ in range(8):
        bad = 1.0 / (wl * WFCT) != wn
        if not bad.any():
            break
        wl[bad] = np.nextafter(wl[bad], np.where(
            1.0 / (wl[bad] * WFCT) > wn[bad], np.inf, -np.inf))
    return wl


def _lines(name: str):
    """(wl, isoid) of a partition case."""
    rng = np.random.default_rng(11)
    if name == "empty":
        return np.zeros(0), np.zeros(0, np.int32)
    if name == "one_in":
        return _wl_of(np.array([150.3])), np.array([2], np.int32)
    if name == "one_out":
        return _wl_of(np.array([230.0])), np.array([0], np.int32)
    if name == "half_bins":
        # Lines exactly half-way between two oversampled bins (the
        # strict < keeps the lower one) or a whole odwn from a grid point
        # (the strict < ends the group), one isotope; those whose
        # wavenumber no wavelength gives back exactly are left out:
        wn = np.sort(np.concatenate([OWNS[:-1] + 0.5 * ODWN, OWNS,
                                     OWNS[10:20] + 0.8 * ODWN]))
        wl = _wl_of(wn)
        exact = 1.0 / (wl * WFCT) == wn
        assert exact.sum() > 0.5 * wn.shape[0]
        return wl[exact], np.zeros(int(exact.sum()), np.int32)
    if name == "interleaved":
        # Sorted by wavenumber only, so the isotope changes inside runs
        # of lines within odwn of each other; lines on both sides of
        # [wn_i, owns[-1]]:
        wn = np.sort(rng.uniform(95.0, 205.0, 4000))
        return _wl_of(wn), rng.integers(0, 3, wn.shape[0]).astype(np.int32)
    # "tli_order": the TLI's order (by isotope, then wavelength), dense
    # clusters and duplicated wavenumbers, some lines out of range:
    wn = np.concatenate([rng.uniform(90.0, 210.0, 3000),
                         150.0 + rng.normal(0.0, 0.05, 1500),
                         np.repeat(rng.uniform(120.0, 180.0, 100), 4)])
    iso = rng.integers(0, 4, wn.shape[0]).astype(np.int32)
    wl = _wl_of(wn)
    order = np.lexsort((wl, iso))
    return wl[order], iso[order]


PARTITION_CASES = ["tli_order", "interleaved", "half_bins", "one_in",
                   "one_out", "empty"]


def _plan_args(name):
    wl, iso = _lines(name)
    n = wl.shape[0]
    elow = np.linspace(0.0, 3000.0, n)
    gf = np.geomspace(1e-6, 1.0, n)
    return (wl, iso, elow, gf, WFCT), dict(
        wn_i=WN_I, odwn=ODWN, dwn=DWN, owns_v=OWNS, n_coarse=101,
        ofactor=OFACTOR)


def _assert_plans_equal(got, want):
    for f in dataclasses.fields(jlbl.LinePlan):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


@pytest.mark.parametrize("name", PARTITION_CASES)
def test_plan_lines_matches_jax(name):
    """The port's plan_lines (the native group_partition) against JAX's
    Python loop, field for field, and against the port's plain loop."""
    args, kw = _plan_args(name)
    got = lbl.plan_lines(*args, **kw)
    _assert_plans_equal(got, jlbl.plan_lines(*args, **kw))
    _assert_plans_equal(got, lbl.plan_lines_plain(*args, **kw))
    if name == "half_bins":
        # Half-way lines take the lower bin; a line a whole odwn from its
        # group's grid point starts a new group:
        half = np.isin(got.wavn[got.g_primary], OWNS[:-1] + 0.5 * ODWN)
        assert half.any()
        np.testing.assert_array_equal(
            OWNS[got.g_iown[half]], got.wavn[got.g_primary][half] - 0.5 * ODWN)
    if name == "interleaved":
        assert not got.g_inrange.all() and got.g_inrange.any()
        assert got.n_groups < got.n_lines


def _sort_case(name: str):
    """(isoid, wl) of an argsort case."""
    rng = np.random.default_rng(5)
    if name == "empty":
        return np.zeros(0, np.int16), np.zeros(0)
    if name == "one":
        return np.array([3], np.int16), np.array([1.5])
    if name == "single_isotope":
        return (np.full(5000, 7, np.int16),
                np.round(rng.uniform(1.0, 20.0, 5000), 2))
    if name == "specials":
        # -0.0 and +0.0 equal, NaN of either sign last, ties in input
        # order, infinities in place:
        wl = np.array([0.0, -0.0, np.nan, 1.0, -np.nan, -1.0, np.inf, -0.0,
                       -np.inf, 1.0, 0.0, np.nan] * 50)
        return rng.integers(0, 3, wl.shape[0]).astype(np.int16), wl
    # "ties": many isotopes and wavelengths on a coarse grid:
    n = 60000
    return (rng.integers(0, 9, n).astype(np.int16),
            np.round(rng.uniform(0.5, 30.0, n), 1))


SORT_CASES = ["ties", "specials", "single_isotope", "one", "empty"]


@pytest.mark.parametrize("name", SORT_CASES)
def test_argsort_matches_jax(name):
    """argsort_iso_wl (through sort_iso_wl) equals JAX's sort_iso_wl
    (np.lexsort here) and the port's plain version, permutation for
    permutation."""
    isoid, wl = _sort_case(name)
    got = pcompile.sort_iso_wl(isoid, wl)
    want = jsort_iso_wl(isoid, wl)
    assert got.dtype == np.int64 and got.shape == (wl.shape[0],)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, pcompile.sort_iso_wl_plain(isoid, wl))


def test_argsort_refuses_a_wide_isotope_range():
    """An isotope range over 2^22 raises, as JAX's native does."""
    with pytest.raises(ValueError, match="isoid range"):
        _native.argsort_iso_wl(np.array([0, 2 ** 22 + 1], np.int32),
                               np.array([1.0, 2.0]))


def _columns(rng, n: int) -> dict:
    """Fixed-width columns in the forms HITRAN writes: name -> (n, w)
    uint8 records."""
    wn = rng.uniform(0.0, 25000.0, n)
    a = 10.0 ** rng.uniform(-30.0, 3.0, n) * rng.choice([1.0, -1.0], n)
    a[:3] = (0.0, 1e-99, 9.999e99)
    g = rng.integers(-9999, 99999, n)
    fields = {"%12.6f": [f"{v:12.6f}" for v in wn],
              "%10.3E": [f"{v:10.3E}" for v in a],
              "%5d": [f"{v:5d}" for v in g],
              "%1d": [f"{v:1d}" for v in rng.integers(0, 10, n)],
              "%7.1f+nl": [f"{v:7.1f}\n" for v in rng.uniform(0, 999, n)]}
    return {k: np.frombuffer("".join(v).encode(), np.uint8).reshape(n, -1)
            for k, v in fields.items()}


@pytest.mark.parametrize("form", ["%12.6f", "%10.3E", "%5d", "%1d",
                                  "%7.1f+nl"])
def test_parse_matches_jax(form):
    """parse_fixed_floats (through hitran._parse_float) gives float()'s
    bits on every field: JAX's Python parser and the port's plain
    version."""
    rec = _columns(np.random.default_rng(17), 4000)[form]
    got = phitran._parse_float(rec)
    for want in (jparse_float(rec), phitran._parse_float_plain(rec)):
        assert got.dtype == want.dtype == np.float64
        np.testing.assert_array_equal(got.view(np.int64),
                                      want.view(np.int64))


def test_parse_blank_field_is_zero():
    """A blank field parses to 0.0 (C's strtod, as JAX's native), where
    JAX's Python parser and the port's plain version raise; an empty one
    is 0.0 in all three; a field ends at the first byte that is not part
    of a number; a leading + is read."""
    rec = np.frombuffer(b"  2.5E+01   " b"            " b" -7.25xyz 1E"
                        b"   +3.5E-2  ", np.uint8).reshape(4, 12)
    np.testing.assert_array_equal(phitran._parse_float(rec),
                                  [25.0, 0.0, -7.25, 0.035])
    np.testing.assert_array_equal(phitran._parse_float(rec[3:]),
                                  jparse_float(rec[3:]))
    for plain in (jparse_float, phitran._parse_float_plain):
        with pytest.raises(ValueError):
            plain(rec[1:2])
    empty = np.zeros((4, 0), np.uint8)
    np.testing.assert_array_equal(phitran._parse_float(empty), np.zeros(4))
    np.testing.assert_array_equal(jparse_float(empty), np.zeros(4))
    with pytest.raises(ValueError, match="overrun"):
        _native.parse_fixed_floats(b"1.0\n2.0\n", 4, 0, 5, 2)


COMMA_LOCALES = ("de_DE.UTF-8", "de_DE.utf8", "fr_FR.UTF-8", "fr_FR.utf8",
                 "ru_RU.UTF-8", "es_ES.UTF-8", "it_IT.UTF-8", "nl_NL.UTF-8")


def test_parse_ignores_the_process_locale():
    """Under a locale whose decimal point is a comma the parse is the C
    locale's.  Skips where no such locale is installed."""
    rec = _columns(np.random.default_rng(3), 500)["%10.3E"]
    want = jparse_float(rec)
    old = locale.setlocale(locale.LC_NUMERIC)
    try:
        for name in COMMA_LOCALES:
            try:
                locale.setlocale(locale.LC_NUMERIC, name)
            except locale.Error:
                continue
            if locale.localeconv()["decimal_point"] == ",":
                break
        else:
            pytest.skip("no locale with a decimal comma is installed")
        np.testing.assert_array_equal(phitran._parse_float(rec), want)
    finally:
        locale.setlocale(locale.LC_NUMERIC, old)


@pytest.mark.parametrize("fault", ["missing_compiler", "compile_error"])
def test_failed_host_build_raises(fault, tmp_path, monkeypatch):
    """A host library that cannot be built raises with the reason: a CXX
    that names no file, or a source the compiler refuses (its output in
    the message)."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    if fault == "missing_compiler":
        monkeypatch.setenv("CXX", str(tmp_path / "no-such-c++"))
        match = "not found"
    else:
        bad = tmp_path / "lineprep.cpp"
        bad.write_text("int f( {\n")
        monkeypatch.setattr(_build, "HOST_SOURCE", bad)
        match = "host C\\+\\+ build failed"
    with pytest.raises(RuntimeError, match=match):
        _build.build_host()
    assert not list((tmp_path / "build").glob("*.so"))
