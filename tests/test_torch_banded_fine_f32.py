"""plain_banded_extinction against transit_tpu's fast.banded_extinction
on the fine-grid configuration (tests/test_fast_and_forward.py:261: 4001
wavenumbers at 0.01 cm-1, 20 layers, bands=6), whose plan has tile
widths up to 512, decimated asym2 shells at strides 2-16 with
lanes="bins" and tile classes, and a stride-1 r2 shell; np.float32,
far_full_res=False."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tests.test_torch_common import (banded_pair, fine_grid_config, state,
                                     to_numpy)

torch.set_num_threads(1)

TOL = 1e-4


def _rel(a, b, scale):
    """|a - b| / (|a| + 1e-6 scale) elementwise, a the reference (the
    bound of test_torch_common.rel, with the whole array's max)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b) / (np.abs(a) + 1e-6 * scale)


def _jax_band_tiles(jm, dn, args, kw, band, tiles):
    """JAX's extinction of ``band``'s layers on the global tiles ``tiles``
    of its plans, the tiles evaluated op by op (not jitted) on the jitted
    per-layer tables: the near plan plus each shell, in
    banded_extinction's order (fast.py:1219-1243), one tile at a time
    through fast._run_tiles -> (the band's layer rows,
    (nrows, len(tiles), tw))."""
    from transit_tpu.opacities import fast as jfast
    bp = jm.bplan
    a, b = bp.slices[band]
    sel = bp.perm[a:b]
    plan = bp.plans[band]
    d = jax.tree_util.tree_map(jnp.asarray, dn[band])
    t, dens, z, mm, mr = (jnp.asarray(x) for x in args)
    targs = (t[sel], dens[:, sel], z[:, sel], mm, mr)
    prep = jax.jit(lambda *a: {
        k: v for k, v in jfast._prep_layers(plan, *a, line_chunk=512).items()
        if k not in ("niso", "dtype")})(d, *targs)
    prep.update(niso=int(d["iso_mass"].shape[0]), dtype=d["all_wavn"].dtype)
    parts = [(plan, d, jfast.voigt_k_humlicek, 1)]
    for (pl, pr, s), (dl, dr) in zip(bp.far_plans[band] or [],
                                     d.get("far", [])):
        parts += [(fp, dict(d, **fd), jfast.FAR_KERNELS[fp.wfn_tag], s)
                  for fp, fd in ((pl, dl), (pr, dr)) if fp is not None]
    ex = 0.0
    for p, pd, voigt, stride in parts:
        assert p.tw == plan.tw
        cols = []
        for g in tiles:
            if p.class_tiles is None:
                dt, lmax, r = pd, p.lmax, g
            else:
                c = next(i for i, ct in enumerate(p.class_tiles) if g in ct)
                dt, lmax = pd["classes"][c], p.class_lmax[c]
                r = int(np.nonzero(np.asarray(p.class_tiles[c]) == g)[0][0])
            dtiles = {k: dt[k][r:r + 1]
                      for k in ("wavn", "elow", "gf", "iso", "mask")}
            val = jfast._run_tiles(p, pd, dtiles, jnp.asarray([g], jnp.int32),
                                   lmax, prep, kw["wn_i"], kw["dwn"],
                                   kw["ethresh"], kw["nwidth"], 512,
                                   voigt_fn=voigt, stride=stride)
            cols.append(np.asarray(val[0]))
        ex = ex + np.stack(cols, axis=1)
    return sel, ex


def test_plain_banded_matches_jax_fine_grid_f32():
    """Held elementwise to 1e-4.  Jitted on the CPU, XLA rounds some bin
    wavenumbers otherwise than op by op (a few float32 ulps at ~2035
    cm-1, in runs of vector lanes), which moves a far line's r2 wing by
    2 ulp / distance (~3e-3 for a line 0.07 cm-1 from the bin).  So
    wherever the port misses jitted JAX by more than 1e-4, the test
    requires that jitted JAX itself misses op-by-op JAX there by more
    than 1e-4, and holds the port to op-by-op JAX on that tile instead;
    such tiles must stay few."""
    jm, ref, got = banded_pair(fine_grid_config(), np.float32,
                               far_full_res=False)
    strides = [s for far in jm.bplan.far_plans if far for *_, s in far]
    assert max(strides) >= 4
    assert got.shape == ref.shape == (20, 4001) and got.dtype == np.float32
    assert np.all(np.isfinite(got)) and got.max() > 0
    scale = float(np.abs(ref).max())
    miss = _rel(ref, got, scale) > TOL
    ref = ref.astype(np.float64)
    patched = 0
    if miss.any():
        args, kw = state(jm, np.float32)
        dn = to_numpy(jm.bdev, np.float32)
        for band, (a, b) in enumerate(jm.bplan.slices):
            rows = jm.bplan.perm[a:b]
            tw = jm.bplan.plans[band].tw
            tiles = sorted({int(c) // tw
                            for c in np.nonzero(miss[rows].any(0))[0]})
            if not tiles:
                continue
            sel, eager = _jax_band_tiles(jm, dn, args, kw, band, tiles)
            for i, g in enumerate(tiles):
                cols = np.arange(g * tw, min((g + 1) * tw, ref.shape[1]))
                e = eager[:, i, :cols.size]
                assert _rel(e, ref[np.ix_(sel, cols)], scale).max() > TOL, \
                    (band, g)
                ref[np.ix_(sel, cols)] = e
                patched += e.size
    assert patched <= 0.01 * ref.size
    assert _rel(ref, got, scale).max() <= TOL
