"""The profile-scatter kernels' tile table and spans (opacities/lbl.py
scatter_tiles, tile_spans), on the CPU: every group in exactly one tile
of at most SCATTER_TILE groups, no tile across an isotope run, on the
fixture's plan and on the full hot-Jupiter line list (benchmarks/data/hj:
194,349 lines); the spans against a loop; and the synthetic case that
chip_smoke.py holds the kernels to on the card, which must reach both
of their paths (tiles inside and wider than the shared segment),
windows clipped at both ends of the row and a layer with no kept group.
Its plain scatter is held to a loop over groups and bins."""

import os

import numpy as np
import pytest
import torch

from chip_smoke import (SYN_SHAPE, exact_bounds, synthetic_scatter,
                        table_elements)
from tests.test_conformance import make_config
from transit_tpu_torch import grids
from transit_tpu_torch.config import TransitConfig
from transit_tpu_torch.constants import TLI_WAV_UNITS
from transit_tpu_torch.io.tli import read_tli, select_lines
from transit_tpu_torch.model import TransitModel
from transit_tpu_torch.opacities import _build, lbl

torch.set_num_threads(1)

HJ = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "benchmarks", "data", "hj")


def _hj_plan():
    """The port's line plan of the hot-Jupiter list on hj_ref.cfg's grid
    (500-10000 cm-1 at 0.5 cm-1, oversampled 2160 times)."""
    wns, owns = grids.make_wn_sampling(wnlow=500.0, wnhigh=10000.0,
                                       wndelt=0.5, wnosamp=2160, wnfct=1.0)
    wl, isoid, elow, gf = select_lines(read_tli(f"{HJ}/hj.tli"), wns.i,
                                       wns.f)
    return lbl.plan_lines(wl, isoid, elow, gf, TLI_WAV_UNITS, wn_i=wns.i,
                          odwn=owns.d / owns.o, dwn=wns.d / wns.o,
                          owns_v=owns.v, n_coarse=wns.n, ofactor=owns.o)


@pytest.fixture(scope="module")
def fixture_model():
    import dataclasses
    return TransitModel(TransitConfig(**dataclasses.asdict(
        make_config("eclipse", 1e30))), dtype=torch.float64, device="cpu")


def _check_tiles(tiles, g_iso, tile=lbl.SCATTER_TILE):
    ng = g_iso.shape[0]
    assert tiles.dtype == np.int32 and tiles[0] == 0 and tiles[-1] == ng
    sizes = np.diff(tiles)
    assert sizes.min() >= 1 and sizes.max() <= tile
    tile_of = np.repeat(np.arange(sizes.shape[0]), sizes)
    assert tile_of.shape == (ng,)          # each group in exactly one tile
    first = tiles[:-1][tile_of]
    assert np.array_equal(g_iso, g_iso[first])   # no tile crosses a run
    new = np.flatnonzero(np.r_[True, g_iso[1:] != g_iso[:-1]])
    assert np.isin(new, tiles).all()


@pytest.mark.parametrize("which", ["fixture", "hotjupiter"])
def test_scatter_tiles_cover_groups_within_runs(which, fixture_model):
    if which == "fixture":
        plan = fixture_model.plan
    else:
        plan = _hj_plan()
        assert plan.n_groups == 193665
    g_iso = plan.isoid[plan.g_primary]
    tiles = lbl.scatter_tiles(g_iso)
    _check_tiles(tiles, g_iso)
    runs = int((np.diff(g_iso) != 0).sum()) + 1
    assert tiles.shape[0] - 1 >= max(runs, -(-plan.n_groups //
                                             lbl.SCATTER_TILE))
    if which == "hotjupiter":
        assert runs == 4 and tiles.shape[0] - 1 == 758


@pytest.mark.parametrize("tile", [1, 3, 256])
def test_scatter_tiles_small_cases(tile):
    g_iso = np.array([0, 0, 0, 0, 0, 1, 1, 2, 0, 0], dtype=np.int32)
    tiles = lbl.scatter_tiles(g_iso, tile)
    _check_tiles(tiles, g_iso, tile)
    if tile == 256:
        np.testing.assert_array_equal(tiles, [0, 5, 7, 8, 10])


def test_check_tiles_takes_the_built_tables(fixture_model):
    plan = fixture_model.plan
    lbl.check_tiles(lbl.scatter_tiles(plan.isoid[plan.g_primary]),
                    plan.n_groups)
    lbl.check_tiles(np.arange(701, dtype=np.int32), 700)
    lbl.check_tiles([0, 256, 512, 700], 700)


@pytest.mark.parametrize("tiles, match", [
    ([[0, 5], [5, 10]], "group starts"),
    ([0], "group starts"),
    ([1, 256, 700], "from 0 to ng"),
    ([0, 256, 699], "from 0 to ng"),
    ([0, 256, 701], "from 0 to ng"),
    ([0, 257, 700], "1 to 256"),
    ([0, 300, 200, 700], "1 to 256"),
    ([0, 256, 256, 512, 700], "1 to 256"),
])
def test_check_tiles_refuses_a_malformed_table(tiles, match):
    """A tile table the kernels would misread (a tile longer than
    SCATTER_TILE, descending or empty, not from 0 to ng) is refused."""
    with pytest.raises(ValueError, match=match):
        lbl.check_tiles(np.asarray(tiles, dtype=np.int32), 700)


def test_csrc_constants_match_lbl():
    """lbl's SCATTER_TILE and SCATTER_SEGMENT are the kernels' PS_TILE and
    PS_SEG (compile-time constants of csrc/profile_scatter.cu)."""
    import re
    src = next(p for p in _build.sources()
               if p.name == "profile_scatter.cu").read_text()
    consts = dict(re.findall(r"constexpr int (PS_\w+) = (\d+);", src))
    assert consts == {"PS_TILE": str(lbl.SCATTER_TILE),
                      "PS_SEG": str(lbl.SCATTER_SEGMENT)}


def test_device_arrays_carry_the_tile_table(fixture_model):
    m = fixture_model
    s = lbl.scatter_tables(m.plan, m.dev)
    want = lbl.scatter_tiles(m.plan.isoid[m.plan.g_primary])
    assert s.tiles.dtype == torch.int32
    np.testing.assert_array_equal(s.tiles.numpy(), want)


def _spans_loop(mask, g_idop, ilor, s):
    _, _, _, minj, maxj = lbl.scatter_geometry(g_idop, ilor, s)
    tiles = s.tiles.numpy()
    out = np.zeros((mask.shape[0], tiles.shape[0] - 1), dtype=np.int64)
    for l in range(mask.shape[0]):
        for t in range(tiles.shape[0] - 1):
            lo, hi = 1 << 40, -1
            for g in range(tiles[t], tiles[t + 1]):
                a, z = int(minj[l, g]), int(maxj[l, g])
                if mask[l, g] and a <= z:
                    lo, hi = min(lo, a), max(hi, z)
            out[l, t] = hi - lo + 1 if hi >= 0 else 0
    return out


def test_tile_spans_match_a_loop_on_the_fixture(fixture_model):
    m = fixture_model
    t = m._t(m.atm.temp)
    grp = lbl.layer_groups(m.dev, t * m.atm.tfct, m._t(m.atm.d),
                           m.partition(t), m._molm_t, m._molrad_t,
                           float(m.wns.v[0]), m.cfg.ethreshold)
    s = lbl.scatter_tables(m.plan, m.dev)
    got = lbl.tile_spans(grp["keep"], grp["g_idop"], grp["ilor"], s)
    np.testing.assert_array_equal(
        got.numpy(), _spans_loop(grp["keep"], grp["g_idop"], grp["ilor"], s))
    assert int(got.max()) > 0


def _plain_loop(g_k, g_idop, ilor, s):
    """out[l, j] by a loop over (layer, group), float64."""
    psize, pbase, offset, minj, maxj = (
        a.numpy() for a in lbl.scatter_geometry(g_idop, ilor, s))
    flat = s.profflat.numpy().astype(np.float64)
    k = g_k.numpy().astype(np.float64)
    out = np.zeros((k.shape[0], s.n_coarse))
    for l, g in zip(*np.nonzero(k)):
        j = np.arange(minj[l, g], maxj[l, g] + 1)
        f = s.ofactor * j - offset[l, g]
        ok = (f >= 0) & (f <= 2 * psize[l, g])
        out[l, j[ok]] += k[l, g] * flat[pbase[l, g] + f[ok]]
    return out


@pytest.mark.parametrize("nl", [1, SYN_SHAPE[0]])
def test_synthetic_case_reaches_every_path(nl):
    g_k, keep, g_idop, ilor, s = synthetic_scatter("cpu", nl=nl)
    assert g_k.shape == (nl, SYN_SHAPE[1]) and s.n_coarse == SYN_SHAPE[2]
    assert SYN_SHAPE[1] % lbl.SCATTER_TILE != 0
    _check_tiles(s.tiles.numpy(), s.g_iso.numpy())
    spans = lbl.tile_spans(keep, g_idop, ilor, s)
    assert bool((spans > lbl.SCATTER_SEGMENT).any())
    assert bool(((spans > 0) & (spans <= lbl.SCATTER_SEGMENT)).any())
    _, _, _, minj, maxj = lbl.scatter_geometry(g_idop, ilor, s)
    raw_lo = s.g_idwn.long() - torch.div(
        s.profsize.long()[g_idop.long(), ilor.long()[:, s.g_iso.long()]] -
        (s.g_iown.long() - s.g_idwn.long() * s.ofactor), s.ofactor,
        rounding_mode="trunc")
    assert bool((keep & (raw_lo < 0) & (minj == 0)).any())
    assert bool((keep & (maxj == s.n_coarse - 1)).any())
    if nl > 1:
        assert not bool(keep[1].any()) and bool(keep[0].any())
    want = _plain_loop(g_k, g_idop, ilor, s)
    got = lbl.profile_scatter_plain(g_k, g_idop, ilor, s).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * want.max())
    assert lbl.scatter_pairs(g_k, g_idop, ilor, s) > 0


def test_synthetic_case_with_tiles_across_runs():
    """A tile table cut every SCATTER_TILE groups regardless of runs
    (the kernels stay right on it: their card test runs it) crosses the
    run boundary at group 300, and the crossing tile's span holds both
    runs' windows."""
    ng = SYN_SHAPE[1]
    naive = np.append(np.arange(0, ng, lbl.SCATTER_TILE), ng)
    g_k, keep, g_idop, ilor, s = synthetic_scatter("cpu", tiles=naive)
    g_iso = s.g_iso.numpy()
    assert g_iso[naive[1]] != g_iso[naive[2] - 1]
    spans = lbl.tile_spans(keep, g_idop, ilor, s)
    assert spans.shape == (SYN_SHAPE[0], naive.shape[0] - 1)
    np.testing.assert_array_equal(
        spans.numpy(), _spans_loop(keep, g_idop, ilor, s))


def _elements_loop(mask, g_idop, ilor, s):
    """The distinct table indices pbase + ofactor*j - offset of the
    scatter's pairs over ``mask``, by a loop over (layer, group)."""
    psize, pbase, offset, minj, maxj = (
        a.numpy() for a in lbl.scatter_geometry(g_idop, ilor, s))
    seen = set()
    for l, g in zip(*np.nonzero(mask.numpy())):
        j = np.arange(minj[l, g], maxj[l, g] + 1)
        f = s.ofactor * j - offset[l, g]
        seen.update((pbase[l, g] + f[(f >= 0) & (f <= 2 * psize[l, g])])
                    .tolist())
    return len(seen)


def test_table_elements_match_a_loop(fixture_model):
    """chip_smoke.table_elements (the table bytes of the kernels' bound)
    against a loop, on the fixture's groups (20 layers: two chunks) and
    on the synthetic case; exact_bounds charges them and the pairs."""
    m = fixture_model
    t = m._t(m.atm.temp)
    grp = lbl.layer_groups(m.dev, t * m.atm.tfct, m._t(m.atm.d),
                           m.partition(t), m._molm_t, m._molrad_t,
                           float(m.wns.v[0]), m.cfg.ethreshold)
    s = lbl.scatter_tables(m.plan, m.dev)
    args = (grp["g_idop"], grp["ilor"], s)
    want = _elements_loop(grp["keep"], *args)
    assert m.atm.nlayers == 20
    assert 0 < want == table_elements(grp["keep"], *args)
    bounds = exact_bounds(grp, s)
    for name in ("profile_scatter", "profile_scatter_backward"):
        b = bounds[name]
        assert b["table_elements"] == want and b["bound_ms"] > 0
        assert b["pairs"] == lbl.scatter_pairs(grp["g_k"], *args)
        assert b["bound_by"] == "bytes"
    g_k, keep, g_idop, ilor, s = synthetic_scatter("cpu")
    assert table_elements(keep, g_idop, ilor, s) == _elements_loop(
        keep, g_idop, ilor, s)


def test_launch_checks_a_tile_table_once_per_tensor(monkeypatch):
    """The kernel wrappers' check of the tile table (kernel_profile.
    _check_tiles): lbl.check_tiles once per tensor, not at every launch,
    and a malformed table is refused with the wrapper's name."""
    from transit_tpu_torch.opacities import kernel_profile
    calls = []

    def counted(tiles, ng):
        calls.append(ng)
        lbl.check_tiles(tiles, ng)

    monkeypatch.setattr(kernel_profile, "check_tiles", counted)
    good = torch.tensor([0, 256, 512, 700], dtype=torch.int32)
    for _ in range(3):
        kernel_profile._check_tiles("profile_scatter", good, 700)
    assert calls == [700]
    bad = torch.tensor([0, 300, 700], dtype=torch.int32)
    for _ in range(2):
        with pytest.raises(ValueError, match="^profile_scatter: .*1 to 256"):
            kernel_profile._check_tiles("profile_scatter", bad, 700)
    assert calls == [700, 700, 700]
