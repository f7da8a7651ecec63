"""The port's grid-interpolation mode and extinction savefile against the
JAX package's, float64 on the CPU: grid_extinction and its gradient in
T and in the densities (temperatures below tlow and above thigh
included) against JAX's value and jax.grad within 1e-9 of the max; the
grid-mode model (no line list read) against ref_eclipse_gridmode.npz at
tests/test_opacity_grid.py:58-68's tolerances and against JAX's
grid-mode compute within 1e-12; its forward's gradient against jax.grad;
forward_batch in grid mode; the savefile written and restored by
compute, and never by forward (tests/test_aux.py:50-83)."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_conformance import GOLD, make_config
from tests.test_opacity_grid import grid_config
from tests.test_torch_common import port_config
from transit_tpu.model import TransitModel as JModel
from transit_tpu.opacities import grid as jgrid
from transit_tpu_torch.model import TransitModel
from transit_tpu_torch.opacities import grid

torch.set_num_threads(1)

GRID = os.path.join(GOLD, "ref_opacity_grid.bin")


@pytest.fixture(scope="module")
def pair():
    """The JAX and port grid-mode models (fast mode, so that
    forward_batch runs; grid mode reads no line list either way)."""
    cfg = grid_config(opacityfile=GRID)
    return JModel(cfg, mode="fast"), TransitModel(
        port_config(cfg), mode="fast", dtype=torch.float64, device="cpu")


@pytest.fixture(scope="module")
def jax_results(pair):
    """JAX's grid-mode results, jitted (an eager call compiles op by op,
    ~12 s each): compute's spectrum and extinction, the gradient of
    sum(forward) in T and q at 1.05 T, and forward_batch of batch(jm)."""
    jm, _ = pair
    spec, ext = jax.jit(lambda: (lambda r: (r.spectrum, r.extinction))(
        jm.compute()))()
    gT, gq = jax.jit(jax.grad(lambda t, q: jnp.sum(jm.forward(t, q)),
                              argnums=(0, 1)))(
        jnp.asarray(jm.atm.temp * 1.05), jnp.asarray(jm.atm.q))
    T, q = batch(jm)
    fb = jax.jit(jm.forward_batch)(jnp.asarray(T), jnp.asarray(q))
    return {k: np.asarray(v) for k, v in dict(
        spec=spec, ext=ext, gT=gT, gq=gq, batch=fb).items()}


def batch(m):
    """Three profiles near the file's, made from a seed."""
    rng = np.random.default_rng(2)
    T = m.atm.temp * (1.0 + 0.05 * rng.uniform(-1, 1, (3, 1)))
    return T, np.repeat(m.atm.q[None], 3, axis=0)


def max_rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def test_grid_extinction_and_gradient_equal_jax():
    og = grid.read_opacity_grid(GRID)
    nl = og.grid.shape[0]
    rng = np.random.default_rng(4)
    T = np.linspace(800.0, 2300.0, nl)          # below tlow, above thigh
    T[[3, 7]] = og.temp[[0, -1]]                # on the grid's ends
    dens = rng.uniform(0.5, 2.0, (3, nl)) * 1e-5
    mol = np.array([2])
    w = rng.standard_normal((nl, og.grid.shape[3]))

    def jfn(t, d):
        return jnp.sum(w * jgrid.grid_extinction(
            jnp.asarray(og.temp), jnp.asarray(og.grid), jnp.asarray(mol),
            t, d))

    want = np.asarray(jgrid.grid_extinction(
        jnp.asarray(og.temp), jnp.asarray(og.grid), jnp.asarray(mol),
        jnp.asarray(T), jnp.asarray(dens)))
    gT, gd = jax.grad(jfn, argnums=(0, 1))(jnp.asarray(T), jnp.asarray(dens))
    t = torch.tensor(T, requires_grad=True)
    d = torch.tensor(dens, requires_grad=True)
    g = torch.tensor(og.grid)
    ext = grid.grid_extinction(torch.as_tensor(og.temp), g,
                               torch.as_tensor(mol), t, d)
    a, b = torch.autograd.grad((torch.as_tensor(w) * ext).sum(), (t, d))
    assert not g.requires_grad
    assert max_rel(ext.detach(), want) <= 1e-9
    assert max_rel(a, gT) <= 1e-9 and float(a.abs().max()) > 0
    assert max_rel(b, gd) <= 1e-9 and float(b[2].abs().max()) > 0
    assert float(b[:2].abs().max()) == 0.0      # molecules not in the grid


def test_gridmode_reads_no_line_list(pair):
    jm, m = pair
    assert m.ogrid is not None and m.tli is None
    assert m.plan is None and m.table is None and m.dev is None
    assert m.device_tree() is m._ogrid_t
    assert m.grid_mol_idx.tolist() == jm.grid_mol_idx.tolist()


def test_gridmode_compute_matches_golden_and_jax(pair, jax_results):
    _, m = pair
    gold = np.load(os.path.join(GOLD, "ref_eclipse_gridmode.npz"))
    res = m.compute()
    ext, spec = res.extinction.numpy(), res.spectrum.numpy()
    np.testing.assert_allclose(ext, gold["ext"], rtol=5e-5,
                               atol=gold["ext"].max() * 1e-10)
    np.testing.assert_allclose(spec, gold["spec"], rtol=1e-5)
    assert max_rel(ext, jax_results["ext"]) <= 1e-12
    np.testing.assert_allclose(spec, jax_results["spec"], rtol=1e-12)


def test_gridmode_gap_to_line_by_line_is_the_references(pair, jax_results):
    """Grid mode against line-by-line at the file atmosphere: the port's
    |grid / lbl - 1| (lbl: the reference C program's line-by-line
    spectrum, ref_eclipse.npz) equals JAX's within 1e-12 and the
    reference C program's own (its grid-mode spectrum against its
    line-by-line one, both goldens of the same configuration) within
    1e-5: the gap is the grid method's, which interpolates each cell's
    extinction linearly in T and cuts lines per grid molecule."""
    _, m = pair
    lbl = np.load(os.path.join(GOLD, "ref_eclipse.npz"))["spec"]
    c_grid = np.load(os.path.join(GOLD, "ref_eclipse_gridmode.npz"))["spec"]
    port = m.forward(torch.as_tensor(m.atm.temp),
                     torch.as_tensor(m.atm.q)).numpy()
    gap = port / lbl - 1.0
    np.testing.assert_allclose(gap, jax_results["spec"] / lbl - 1.0,
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(gap, c_grid / lbl - 1.0, rtol=0, atol=1e-5)
    assert np.abs(gap).max() > 1e-6       # the method's gap, not zero


def test_gridmode_gradient_equals_jax(pair, jax_results):
    _, m = pair
    t = torch.tensor(m.atm.temp * 1.05, requires_grad=True)
    q = torch.tensor(m.atm.q, requires_grad=True)
    a, b = torch.autograd.grad(m.forward(t, q).sum(), (t, q))
    assert max_rel(a, jax_results["gT"]) <= 1e-9
    assert max_rel(b, jax_results["gq"]) <= 1e-9


def test_gridmode_forward_batch(pair, jax_results):
    """A fast-mode grid model's forward_batch equals a loop of forward
    (the grid's rows of each member's layers); JAX's, which has no grid
    branch, leaves the line term out; an exact-mode model refuses it
    with JAX's message."""
    _, m = pair
    T, q = batch(m)
    got = m.forward_batch(torch.as_tensor(T), torch.as_tensor(q))
    for i in range(3):
        np.testing.assert_allclose(got[i].numpy(),
                                   m.forward(T[i], q[i]).numpy(), rtol=1e-12)
    assert max_rel(jax_results["batch"], got.numpy()) > 1e-3
    me = TransitModel(port_config(grid_config(opacityfile=GRID)),
                      dtype=torch.float64, device="cpu")
    with pytest.raises(ValueError, match="mode='fast'"):
        me.forward_batch(torch.as_tensor(T), torch.as_tensor(q))


def test_gridmode_refuses_a_grid_of_another_shape(tmp_path):
    og = grid.read_opacity_grid(GRID)
    p = tmp_path / "short.bin"
    grid.write_opacity_grid(str(p), dataclasses.replace(
        og, wns=og.wns[:50], grid=og.grid[..., :50]))
    cfg = port_config(grid_config(opacityfile=str(p)))
    with pytest.raises(ValueError, match="50 wavenumbers"):
        TransitModel(cfg, dtype=torch.float64, device="cpu")


def saveext_models(tmp_path, mode):
    cfg = port_config(make_config("eclipse", 1e30))
    cfg.saveext = str(tmp_path / "ext.save")
    return cfg, lambda: TransitModel(cfg, mode=mode, dtype=torch.float64,
                                     device="cpu")


def test_saveext_roundtrip_and_reuse(tmp_path):
    cfg, make = saveext_models(tmp_path, "fast")
    res1 = make().compute()
    assert os.path.exists(cfg.saveext)
    with open(cfg.saveext, "rb") as f:
        first = f.read()
    m2 = make()
    m2.line_extinction = None            # restoring computes no lines
    res2 = m2.compute()
    np.testing.assert_array_equal(res2.extinction.numpy(),
                                  res1.extinction.numpy())
    np.testing.assert_allclose(res2.spectrum.numpy(), res1.spectrum.numpy(),
                               rtol=1e-12)
    with open(cfg.saveext, "rb") as f:
        assert f.read() == first         # a valid file is not rewritten


def test_saveext_does_not_change_forward_gradients(tmp_path):
    """forward never restores the savefile: its gradient with a savefile
    present equals the gradient without one (transit_tpu
    model.py:387-402); compute still restores."""
    cfg, make = saveext_models(tmp_path, "fast")
    plain = TransitModel(dataclasses.replace(cfg, saveext=None), mode="fast",
                         dtype=torch.float64, device="cpu")
    res1 = make().compute()
    assert os.path.exists(cfg.saveext)
    m2 = make()

    def grads(m):
        t = torch.tensor(m.atm.temp, requires_grad=True)
        q = torch.tensor(m.atm.q, requires_grad=True)
        return torch.autograd.grad(m.forward(t, q).sum(), (t, q))

    for a, b in zip(grads(m2), grads(plain)):
        assert torch.isfinite(a).all() and float(a.abs().max()) > 0
        assert torch.equal(a, b)
    res2 = m2.compute()
    np.testing.assert_array_equal(res2.extinction.numpy(),
                                  res1.extinction.numpy())


def test_saveext_of_another_shape_is_rewritten(tmp_path):
    cfg, make = saveext_models(tmp_path, "fast")
    with open(cfg.saveext, "wb") as f:
        f.write(b"@E@S@" + b"\0" * 64)
    res = make().compute()
    with open(cfg.saveext, "rb") as f:
        raw = f.read()
    nl, nwn = res.extinction.shape
    assert len(raw) == 5 + 8 * nl * nwn + 2 * nl
