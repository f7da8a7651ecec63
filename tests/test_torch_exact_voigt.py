"""Exact mode's Voigt layer of the port (opacities/voigt.py: voigt_k,
the bin-averaged profiles and the profile table) against transit_tpu's,
in float64 (tier-1 runs JAX with x64): voigt_k within 1e-13 relative on
a grid across its three regions and their edges; the profiles against
the reference C's (tests/golden/voigtn_profiles.npz, tests/test_voigt.py's
rtol 2e-5); the sizing functions equal; the profile table of the
conformance configuration (ndop = nlor = 15) with equal axes, sizes and
bases, and its flat profiles within 1 float32 ulp of JAX's."""

import functools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_conformance import GOLD, make_config
from transit_tpu.opacities import voigt as jv
from transit_tpu_torch import grids
from transit_tpu_torch.opacities import voigt as tv

torch.set_num_threads(1)

# x across region I (x < 3), II (x < 5) and III, with both sides of each
# edge and far-wing values; y likewise (1.8 and 5).
X = np.concatenate([np.linspace(0.0, 8.0, 801),
                    [0.999999, 1.0, 1.000001, 2.9999999, 3.0, 3.0000001,
                     4.99999, 5.0, 5.00001, 1e2, 1e4]])
Y = [1e-6, 0.5, 1.79999, 1.8, 1.80001, 4.9999, 5.0, 5.0001, 20.0]


@pytest.mark.parametrize("y", Y)
def test_voigt_k_matches_jax(y):
    a = np.asarray(jv.voigt_k(jnp.asarray(X), jnp.asarray(y)))
    b = tv.voigt_k(torch.as_tensor(X), y).numpy()
    assert np.all(a > 0)
    assert float(np.max(np.abs(a - b) / np.abs(a))) <= 1e-13


def test_voigt_profile_matches_jax():
    wn = np.linspace(1999.0, 2001.0, 401)
    for aL, aD in ((1e-3, 5e-3), (0.05, 0.02), (2.0, 1e-3)):
        a = np.asarray(jv.voigt_profile(jnp.asarray(wn), 2000.0, aL, aD))
        b = tv.voigt_profile(torch.as_tensor(wn), 2000.0, aL, aD).numpy()
        assert float(np.max(np.abs(a - b) / np.abs(a))) <= 1e-13


def test_bin_averaged_profiles_match_reference():
    """Against the reference C's voigtn output, every golden case in one
    batched evaluation, at tests/test_voigt.py:56's tolerance."""
    g = np.load(os.path.join(GOLD, "voigtn_profiles.npz"))
    meta = g["meta"]
    specs = [(int(n), float(d), float(lor), float(dop), bool(q))
             for n, d, lor, dop, q in meta]
    got = tv.bin_averaged_profiles(specs)
    assert any(q for *_, q in specs) and len(got) == meta.shape[0]
    for k, ours in enumerate(got):
        ref = g[f"prof{k}"]
        assert ours.shape == ref.shape and ours.dtype == np.float32
        np.testing.assert_allclose(ours, ref, rtol=2e-5, atol=0.0,
                                   err_msg=f"case {k}: {meta[k]}")
        one = tv.bin_averaged_profile(*specs[k])
        np.testing.assert_array_equal(one, ours)


def test_sizing_matches_jax():
    for args in ((1e-3, 0.25, 60), (1e-4, 10.0, 60), (1e-3, 0.25, 15)):
        np.testing.assert_array_equal(tv.logspace_ref(*args),
                                      jv.logspace_ref(*args))
    for args in ((1e-3, 0.01, 0.02, 20.0, 10 ** 6),
                 (1.0, 1e-6, 1e-6, 20.0, 100), (1e-5, 10.0, 1.0, 20.0, 50),
                 (0.5 / 2160, 0.25, 10.0, 20.0, 19001 * 2160)):
        assert tv.getprofile_size(*args) == jv.getprofile_size(*args)
    for args in ((101, 0.5, 1e-3, False), (101, 0.5, 0.3, False),
                 (2001, 1e-3, 0.02, False), (200001, 10.0, 0.02, True),
                 (43633, 101.0, 0.25, False)):
        assert tv._voigtn_plan(*args) == jv._voigtn_plan(*args)
    assert tv.VOIGT_MAXELEMENTS == jv.VOIGT_MAXELEMENTS


def table_kw():
    """The conformance configuration's table arguments
    (tests/test_conformance.py's make_config: 1 cm-1 x 216 over
    2000-2100 cm-1, nwidth 20, 15 x 15 widths)."""
    cfg = make_config("eclipse", 1e30)
    wns, owns = grids.make_wn_sampling(
        wnlow=cfg.wnlow, wnhigh=cfg.wnhigh, wndelt=cfg.wndelt,
        wnosamp=cfg.wnosamp, wnfct=cfg.wnfct)
    return dict(dwn=wns.d / owns.o, nwave=owns.n, nwidth=cfg.nwidth,
                ndop=cfg.ndop, nlor=cfg.nlor, dmin=cfg.dmin, dmax=cfg.dmax,
                lmin=cfg.lmin, lmax=cfg.lmax)


# The table's profiles are held to JAX's in TABLE_PARTS parts, one a
# file (this one and tests/test_torch_exact_table_*.py): JAX evaluates
# 4.3e7 padded fine samples for the whole table, ~20 s on one core.
TABLE_PARTS = 3


@functools.lru_cache(maxsize=1)
def port_table():
    """The port's conformance table, built once a process."""
    return tv.build_profile_table(**table_kw())


def check_table_part(part: int):
    """The port's conformance table's profiles of one part (a greedy
    split of the distinct profiles by JAX's padded sample count) against
    transit_tpu's bin_averaged_profile, called as its
    build_profile_table calls it: within 1 float32 ulp (a float64 libm
    ulp that survives the cast), the count that differ printed."""
    kw = table_kw()
    got = port_table()
    cells = {}
    for i in range(got.ndop):
        for j in range(got.nlor):
            cells.setdefault(int(got.base[i, j]), (i, j))
    load, parts = [0] * TABLE_PARTS, [[] for _ in range(TABLE_PARTS)]
    for base, (i, j) in sorted(cells.items()):
        nvgt = 2 * int(got.profsize[i, j]) + 1
        spec = (nvgt, kw["dwn"] * (nvgt // 2), got.aLor[j], got.aDop[i],
                nvgt > jv.VOIGT_MAXELEMENTS)
        size = jv._bucket(jv._voigtn_plan(nvgt, spec[1], spec[3],
                                          spec[4])[0])
        k = min(range(TABLE_PARTS), key=lambda x: (load[x], x))
        load[k] += size
        parts[k].append((base, spec))
    ulps = []
    for base, spec in sorted(parts[part], key=lambda x: -x[1][0]):
        ref = jv.bin_averaged_profile(*spec)
        ours = got.flat[base:base + spec[0]]
        assert ours.shape == ref.shape and ref.dtype == np.float32
        ulps.append(np.abs(ours.view(np.int32).astype(np.int64) -
                           ref.view(np.int32).astype(np.int64)))
    ulps = np.concatenate(ulps)
    print(f"profile table part {part}: {len(parts[part])} profiles, "
          f"{int((ulps != 0).sum())} of {ulps.size} values differ, max "
          f"{int(ulps.max())} ulp")
    assert int(ulps.max()) <= 1


def test_profile_table_matches_jax(monkeypatch):
    """The conformance table: aDop, aLor, profsize and base equal to
    JAX's build_profile_table's (its profiles stubbed: its own loop
    decides the cells, sizes and reuse), the flat buffer as long; the
    profiles of part 0 within 1 ulp of JAX's (check_table_part)."""
    kw = table_kw()
    monkeypatch.setattr(jv, "bin_averaged_profile",
                        lambda nwn, *a: np.zeros(nwn, np.float32))
    ref = jv.build_profile_table(**kw)
    monkeypatch.undo()
    got = port_table()
    for k in ("aDop", "aLor", "profsize", "base"):
        np.testing.assert_array_equal(getattr(got, k), getattr(ref, k))
    assert got.flat.dtype == np.float32 and got.flat.shape == ref.flat.shape
    check_table_part(0)
