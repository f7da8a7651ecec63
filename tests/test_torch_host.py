"""The port's host modules against transit_tpu's on the fixtures: numpy
results are exactly equal; the torch splines agree with the jnp splines
to rounding."""

import dataclasses
import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from tests.test_conformance import FIX, make_config
from transit_tpu import grids as jgrids
from transit_tpu.io import atmosphere as jatm, crosssec as jcs, tli as jtli
from transit_tpu.numerics import simpson as jsimp, spline as jspl
from transit_tpu.numerics import search as jsearch
from transit_tpu.rt import tau as jtau
from transit_tpu_torch import grids as tgrids
from transit_tpu_torch.io import atmosphere as tatm, crosssec as tcs
from transit_tpu_torch.io import tli as ttli
from transit_tpu_torch.numerics import simpson as tsimp, spline as tspl
from transit_tpu_torch.numerics import search as tsearch
from transit_tpu_torch.rt import tau as ttau

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HJ = os.path.join(ROOT, "benchmarks", "data", "hj")


def _same(a, b):
    """Dataclasses, dicts, lists and arrays equal field for field."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__
        for f in dataclasses.fields(a):
            _same(getattr(a, f.name), getattr(b, f.name))
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and np.array_equal(a, b, equal_nan=True)
    else:
        assert a == b


@pytest.mark.parametrize("kw", [
    dict(wnlow=2000.0, wnhigh=2100.0, wndelt=1.0, wnosamp=216),
    dict(wnlow=500.0, wnhigh=10000.0, wndelt=0.5, wnosamp=2160),
    dict(wllow=1.0, wlhigh=20.0, wndelt=0.25, wnosamp=8)])
def test_wn_sampling(kw):
    _same(jgrids.make_wn_sampling(**kw), tgrids.make_wn_sampling(**kw))


@pytest.mark.parametrize("atm,mol", [
    (f"{FIX}/test.atm", f"{FIX}/molecules.dat"),
    (f"{FIX}/multi.atm", f"{FIX}/molecules_multi.dat"),
    (f"{HJ}/hj.atm", f"{HJ}/molecules.dat")])
def test_read_atmosphere(atm, mol):
    _same(jatm.read_atmosphere(atm, mol), tatm.read_atmosphere(atm, mol))


@pytest.mark.parametrize("path", [f"{FIX}/test.tli", f"{FIX}/multi.tli",
                                  f"{FIX}/demo_ch4.tli"])
def test_read_tli_and_select(path):
    a, b = jtli.read_tli(path), ttli.read_tli(path)
    _same(a.iso_index(), b.iso_index())
    for f in ("wl", "isoid", "elow", "gf"):
        _same(np.asarray(getattr(a, f)), np.asarray(getattr(b, f)))
    lo, hi = 1e4 / a.wl.max() + 5.0, 1e4 / a.wl.min() - 5.0
    _same(jtli.select_lines(a, lo, hi), ttli.select_lines(b, lo, hi))
    for x in (a.wl.min(), np.median(a.wl), a.wl.max() + 1.0):
        for side in ("left", "right"):
            assert (jtli.bisect_mm(a.wl, x, side) ==
                    ttli.bisect_mm(b.wl, x, side))


@pytest.mark.parametrize("path", [f"{FIX}/test_cia.dat",
                                  f"{HJ}/cia_H2_H2.dat",
                                  f"{HJ}/cia_H2_He.dat"])
def test_read_cross_section(path):
    _same(jcs.read_cross_section(path), tcs.read_cross_section(path))


def _fixture_atm():
    return jatm.read_atmosphere(f"{FIX}/test.atm", f"{FIX}/molecules.dat")[0]


def test_simpson_and_eclipse_weights():
    a = _fixture_atm()
    for n in (1, 2, 3, 4, 7, a.radius.shape[0]):
        _same(jsimp.simpson_weights_np(a.radius[:n]),
              tsimp.simpson_weights_np(a.radius[:n]))
    _same(jsimp.suffix_simpson_matrix_np(a.radius),
          tsimp.suffix_simpson_matrix_np(a.radius))
    _same(jsimp.trapz_np(a.radius, a.temp), tsimp.trapz_np(a.radius, a.temp))
    _same(jtau.eclipse_weights(a.radius), ttau.eclipse_weights(a.radius))


def test_splines_numpy_exact():
    tli = jtli.read_tli(f"{FIX}/test.tli")
    a = _fixture_atm()
    for db in tli.databases:
        for iso in db.isotopes:
            _same(jspl.spline_second_derivs_np(db.temps, iso.partition),
                  tspl.spline_second_derivs_np(db.temps, iso.partition))
            _same(jspl.splinterp_np(db.temps, iso.partition, a.temp),
                  tspl.splinterp_np(db.temps, iso.partition, a.temp))
    x = np.sort(np.random.default_rng(0).uniform(0, 10, 9))
    _same(jsearch.nearest_index_np(x, np.linspace(-1, 11, 50)),
          tsearch.nearest_index_np(x, np.linspace(-1, 11, 50)))


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-13),
                                       (torch.float32, 1e-5)])
def test_torch_spline_matches_jnp(dtype, tol):
    rng = np.random.default_rng(1)
    x = np.sort(rng.uniform(100.0, 3000.0, 40))
    y = np.stack([np.cos(x / 300.0) + 2.0, np.log(x)], axis=1)   # (n, 2)
    xout = np.concatenate([rng.uniform(x[0], x[-1], 60), x[[0, 5, -1]]])
    z_ref = np.stack([np.asarray(jspl.spline_second_derivs_jnp(
        jnp.asarray(x), jnp.asarray(y[:, k]))) for k in range(2)], 1)
    ref = np.stack([np.asarray(jspl.spline_eval_jnp(
        jnp.asarray(x), jnp.asarray(y[:, k]), jnp.asarray(z_ref[:, k]),
        jnp.asarray(xout))) for k in range(2)], 1)
    t = lambda a: torch.as_tensor(a, dtype=dtype)
    z = tspl.spline_second_derivs_torch(t(x), t(y),
                                       t(tspl.spline_operator_np(x)))
    if dtype == torch.float64:
        # (float32 second derivatives of smooth data are roundoff-bound
        # in any elimination order; the float32 check is on the values)
        np.testing.assert_allclose(z.numpy(), z_ref, rtol=tol,
                                   atol=tol * np.abs(z_ref).max())
    out = tspl.spline_eval_torch(t(x), t(y), z, t(xout))
    np.testing.assert_allclose(out.double().numpy(), ref, rtol=tol)


def test_config_roundtrip():
    from transit_tpu_torch.config import TransitConfig, validate
    cfg = make_config("eclipse", 1e30)
    port = validate(TransitConfig(**dataclasses.asdict(cfg)))
    assert dataclasses.asdict(port) == dataclasses.asdict(cfg)
