"""The port's multi-process bands (transit_tpu_torch.parallel.multihost)
against transit_tpu.parallel.multihost in one process, float64: the
balanced bounds, the wing margin, the per-band kmax (banded.line_kmax
against fast.line_kmax) and, for each process of a 2-process split, the
band model against JAX's ``build_band_model``, their band spectra at the
global kmax (JAX's ``make_sharded_forward(external_kmax=True)`` on a
1-device mesh), and the concatenated bands against the port's
single-process model.  Three processes: tests/test_torch_multihost_3.py;
a real 2-rank run: tests/test_torch_multihost_procs.py."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax.sharding import Mesh

from tests.test_conformance import FIX, make_config
from tests.test_opacity_grid import grid_config
from transit_tpu.io import tli as jtli
from transit_tpu.opacities import fast as jfast
from transit_tpu.parallel import multihost as jmh
from transit_tpu.parallel.sharded import make_sharded_forward as jsharded
from transit_tpu_torch import grids
from transit_tpu_torch.config import TransitConfig
from transit_tpu_torch.io.tli import read_tli_header
from transit_tpu_torch.model import TransitModel
from transit_tpu_torch.opacities.banded import line_kmax
from transit_tpu_torch.parallel import multihost
from transit_tpu_torch.parallel.sharded import make_sharded_forward

torch.set_num_threads(1)


def _pcfg(jcfg):
    return TransitConfig(**dataclasses.asdict(jcfg))


def _single(pcfg):
    """The port's single-process model (bands=4, float64) and its
    spectrum at the file atmosphere."""
    m = TransitModel(pcfg, mode="fast", dtype=torch.float64, device="cpu",
                     bands=4)
    return m.forward(torch.as_tensor(m.atm.temp),
                     torch.as_tensor(m.atm.q)).numpy()


def _kmax(m, jax_model: bool):
    if jax_model:
        T = jnp.asarray(m.atm.temp)
        return np.asarray(jfast.line_kmax(m.bdev[0], T * m.atm.tfct,
                                          m.partition_jnp(T)))
    T = torch.as_tensor(m.atm.temp)
    return line_kmax(m.bdev[0], T * m.atm.tfct, m.partition(T)).numpy()


def check_bands(nproc: int):
    """Each band model against JAX's, the band spectra at the global
    kmax, and the concatenation against the single-process model."""
    jc = make_config("eclipse", 1e30)
    pc = _pcfg(jc)
    mesh = Mesh(np.array(jax.devices()[:1]), ("wn",))
    pairs = []
    for pid in range(nproc):
        jm, jblk, jb = jmh.build_band_model(jc, nproc, pid)
        pm, blk, b = multihost.build_band_model(pc, nproc, pid,
                                                dtype=torch.float64,
                                                device="cpu")
        assert blk == jblk and np.array_equal(b, jb)
        assert pm.wns_global.n == jm.wns_global.n and pm.wns.n == jm.wns.n
        np.testing.assert_array_equal(pm.wns.v, jm.wns.v)
        assert pm.tli.n_lines == jm.tli.n_lines
        for p, q in zip(pm.bplan.plans, jm.bplan.plans):
            assert (p.ntiles, p.lmax, p.tw) == (q.ntiles, q.lmax, q.tw)
            np.testing.assert_array_equal(p.tile_count, q.tile_count)
        pairs.append((jm, pm))
    kj = [_kmax(jm, True) for jm, _ in pairs]
    kp = [_kmax(pm, False) for _, pm in pairs]
    for a, b in zip(kp, kj):
        np.testing.assert_allclose(a, b, rtol=1e-14, atol=0)
    kg_j, kg_p = np.max(kj, axis=0), torch.as_tensor(np.max(kp, axis=0))
    parts = []
    for jm, pm in pairs:
        want = np.asarray(jsharded(jm, mesh, external_kmax=True)(
            jnp.asarray(jm.atm.temp), jnp.asarray(jm.atm.q),
            jnp.asarray(kg_j)))
        got = make_sharded_forward(pm, external_kmax=True)(
            torch.as_tensor(pm.atm.temp), torch.as_tensor(pm.atm.q),
            kg_p).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-11, atol=0)
        parts.append(got)
    np.testing.assert_allclose(np.concatenate(parts), _single(pc),
                               rtol=1e-11, atol=0)


def test_band_models_match_jax_two_processes():
    check_bands(2)


def _synthetic_tli(path):
    """tests/test_multihost.py:89-121's TLI: 10k lines, 90% of them in
    the first 10% of the window."""
    rng = np.random.default_rng(3)
    wn = np.concatenate([rng.uniform(2000, 2010, 9000),
                         rng.uniform(2010, 2100, 1000)])
    wl = 1.0 / wn / 1e-4
    order = np.argsort(wl)
    data = jtli.TliData(
        version=6, iwav=wl.min(), fwav=wl.max(),
        databases=[jtli.TliDatabase(
            name="syn", molecule="CH4", temps=np.array([100.0, 300.0]),
            isotopes=[jtli.TliIsotope("1", 16.0, 1.0,
                                      np.array([1.0, 2.0]))])],
        wl=wl[order], isoid=np.zeros(10000, np.int16),
        elow=np.full(10000, 100.0), gf=np.full(10000, 1e-6),
        isotran=np.array([10000], dtype=np.uint64))
    jtli.write_tli(path, data)
    return wn


def test_balanced_blocks_equal_jax(tmp_path):
    """On the synthetic clustered TLI (the counts within 1.5x of the
    perfect 2500, as JAX's test) and on the fixture TLI at 2 to 4
    processes: the bounds equal JAX's."""
    path = str(tmp_path / "syn.tli")
    wn = _synthetic_tli(path)
    wns_v = 2000.0 + np.arange(101.0)
    bounds = multihost.balanced_blocks(path, wns_v, 4)
    np.testing.assert_array_equal(bounds,
                                  jmh.balanced_blocks(path, wns_v, 4))
    counts = [int(((wn >= wns_v[bounds[p]]) &
                   (wn < wns_v[min(bounds[p + 1], 100)])).sum())
              for p in range(4)]
    assert max(counts) < 1.5 * 2500, counts
    tli = os.path.join(FIX, "test.tli")
    wns_v = make_config("eclipse", 1e30).wnlow + np.arange(101.0)
    for nproc in (1, 2, 3, 4):
        np.testing.assert_array_equal(
            multihost.balanced_blocks(tli, wns_v, nproc),
            jmh.balanced_blocks(tli, wns_v, nproc))


def test_wing_margin_equals_jax():
    jc = make_config("eclipse", 1e30)
    pc = _pcfg(jc)
    wns, _ = grids.make_wn_sampling(wnlow=pc.wnlow, wnhigh=pc.wnhigh,
                                    wndelt=pc.wndelt, wnosamp=pc.wnosamp)
    dbs = read_tli_header(pc.linedb)["databases"]
    got = multihost.wing_margin(pc, dbs, wns)
    want = jmh.wing_margin(jc, jtli.read_tli_header(jc.linedb)["databases"],
                           wns)
    assert got > 0 and abs(got - want) <= 1e-12 * want


def test_line_kmax_equals_jax_on_the_whole_list():
    """line_kmax on the single model's line list, the file atmosphere and
    +-50 K."""
    jc = make_config("eclipse", 1e30)
    from transit_tpu.model import TransitModel as JModel
    jm = JModel(jc, mode="fast", bands=4)
    pm = TransitModel(_pcfg(jc), mode="fast", dtype=torch.float64,
                      device="cpu", bands=4)
    for dT in (0.0, 50.0, -50.0):
        Tj = jnp.asarray(jm.atm.temp + dT)
        want = np.asarray(jfast.line_kmax(jm.bdev[0], Tj * jm.atm.tfct,
                                          jm.partition_jnp(Tj)))
        T = torch.as_tensor(pm.atm.temp + dT)
        got = line_kmax(pm.bdev[0], T * pm.atm.tfct, pm.partition(T))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-14, atol=0)


def test_grid_mode_band_models_read_their_columns():
    """Grid mode (tests/test_multihost.py:124-151 on the reference grid
    file): each of 3 band models reads only its wavenumber columns, and
    the concatenated band spectra equal the full grid model's."""
    from tests.test_conformance import GOLD
    cfg = dataclasses.asdict(grid_config())
    cfg["opacityfile"] = os.path.join(GOLD, "ref_opacity_grid.bin")
    pc = TransitConfig(**cfg)
    full = TransitModel(pc, dtype=torch.float64, device="cpu")
    assert full.ogrid is not None
    parts = []
    for pid in range(3):
        bm, blk, _ = multihost.build_band_model(pc, 3, pid,
                                                dtype=torch.float64,
                                                device="cpu")
        assert bm.ogrid is not None and bm.tli is None
        assert bm.ogrid.grid.shape[-1] == blk[1] - blk[0]
        np.testing.assert_array_equal(
            bm.ogrid.grid, full.ogrid.grid[..., blk[0]:blk[1]])
        parts.append(bm.compute().spectrum.numpy())
    np.testing.assert_allclose(np.concatenate(parts),
                               full.compute().spectrum.numpy(), rtol=1e-12)
