"""The port's banded extinction (opacities/banded.py, the plain version of
the banded kernel path) against transit_tpu on the eclipse fixture with
bands=6: the same tile tensors (through convert) into
fast.banded_extinction and plain_banded_extinction.  The banded model,
kmax and split_far=False are in tests/test_torch_banded_model.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_conformance import make_config
from tests.test_torch_common import (port_config, rel, state, to_numpy,
                                     torch_dtype)
from transit_tpu.model import TransitModel as JModel
from transit_tpu.opacities import fast as jfast
from transit_tpu_torch.convert import device_arrays_from_numpy
from transit_tpu_torch.model import TransitModel
from transit_tpu_torch.opacities import _build, banded, kernel_lbl
from transit_tpu_torch.opacities import kernel_shell

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jax_banded():
    """The JAX banded model (f64) and its banded_extinction, jitted once
    per dtype."""
    jm = JModel(make_config("eclipse", 1e30), mode="fast", bands=6)
    kw = state(jm, np.float64)[1]
    fn = jax.jit(lambda dev, *a: jfast.banded_extinction(jm.bplan, dev, *a,
                                                         **kw))
    return jm, fn


@pytest.fixture(scope="module")
def port64():
    return TransitModel(port_config(make_config("eclipse", 1e30)), mode="fast",
                        dtype=torch.float64, device="cpu", bands=6)


@pytest.mark.parametrize("npdt,tol", [(np.float64, 1e-10),
                                      (np.float32, 1e-4)])
def test_plain_banded_matches_jax(jax_banded, port64, npdt, tol):
    jm, fn = jax_banded
    args, kw = state(jm, npdt)
    dn = to_numpy(jm.bdev, npdt)
    ref = np.asarray(fn(jax.tree_util.tree_map(jnp.asarray, dn),
                        *(jnp.asarray(a) for a in args)))
    d = device_arrays_from_numpy(dn, dtype=torch_dtype(npdt), device="cpu")
    got = banded.plain_banded_extinction(
        port64.bplan, d, *(torch.as_tensor(a) for a in args), **kw).numpy()
    assert got.shape == ref.shape == (20, jm.wns.n) and got.dtype == npdt
    assert np.all(np.isfinite(got)) and got.max() > 0
    assert any(port64.bplan.far_plans)      # far shells are on the path
    assert rel(ref, got) <= tol


def test_cpu_tensors_never_touch_the_cuda_build(port64, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("CPU tensors reached the CUDA build")
    monkeypatch.setattr(_build, "build", refuse)
    monkeypatch.setattr(_build, "load_library", refuse)
    args, kw = state(port64, np.float64)
    targs = [torch.as_tensor(a) for a in args]
    counts = (kernel_lbl.line_tile_extinction.launches,
              kernel_lbl.layer_kmax.launches,
              kernel_shell.shell_tile_extinction.launches)
    got = banded.banded_kernel_extinction(port64.bplan, port64.bdev, *targs,
                                          **kw)
    want = banded.plain_banded_extinction(port64.bplan, port64.bdev, *targs,
                                          **kw)
    assert torch.equal(got, want)
    assert counts == (kernel_lbl.line_tile_extinction.launches,
                      kernel_lbl.layer_kmax.launches,
                      kernel_shell.shell_tile_extinction.launches)


def _scatter(out, plan, tiles, rows, val, add):
    """Write (or add) a launch's (nrows, ntiles_c, tw) block into out."""
    g = (torch.arange(plan.ntiles) if tiles is None else tiles.long())
    cols = (g[:, None] * plan.tw + torch.arange(plan.tw)).flatten()
    keep = cols < out.shape[1]
    r, c = rows.long()[:, None], cols[keep][None, :]
    v = val.reshape(rows.shape[0], -1)[:, keep]
    out[r, c] = out[r, c] + v if add else v


@pytest.mark.parametrize("config,far_full_res", [
    ("fixture", False), ("fine", False), ("fine", True)])
def test_launch_sequence_matches_plain(monkeypatch, config, far_full_res):
    """The kernel path's launches (banded._launch_all: one layer_kmax,
    then per band the near classes written and the stride-1 shell classes
    added into one output, then one shell launch that adds the band's
    decimated shells one after another), each kernel replaced by its
    plain version, equal plain_banded_extinction bit for bit: the same
    terms summed in the same order as JAX's ``ex = near + shell_1 +
    ...``."""
    from tests.test_torch_common import fine_grid_config
    cfg = (make_config("eclipse", 1e30) if config == "fixture" else
           fine_grid_config())
    m = TransitModel(port_config(cfg), mode="fast",
                     dtype=torch.float64, device="cpu",
                     bands=6)
    seen = {"line": 0, "shell": 0}

    def line_tile(plan, d, tab, temps, wn_i, dwn, ethresh, nwidth,
                  stats=None, *, tiles, rows, out, accumulate, bins_first):
        sel = rows.long()
        val = kernel_lbl.plain_line_tiles(
            plan, d, {k: v[sel] for k, v in tab.items()}, temps[sel], wn_i,
            dwn, ethresh, nwidth, gidx=None if tiles is None else tiles,
            bins_first=bins_first)
        _scatter(out, plan, tiles, rows, val, accumulate)
        seen["line"] += 1

    def shell_tile(band, tab, temps, wn_i, dwn, ethresh, nwidth, *, rows,
                   out, stats=None, full_res, clip=None):
        kernel_shell.plain_shell_band(band, tab, temps, wn_i, dwn, ethresh,
                                      nwidth, rows=rows, out=out,
                                      full_res=full_res)
        seen["shell"] += 1

    monkeypatch.setattr(banded, "line_tile_extinction", line_tile)
    monkeypatch.setattr(banded, "shell_tile_extinction", shell_tile)
    monkeypatch.setattr(banded, "layer_kmax", kernel_lbl.plain_kmax)
    args, kw = state(m, np.float64)
    targs = [torch.as_tensor(a) for a in args]
    index = banded.banded_index(m.bplan, m.bdev, "cpu")
    tab = banded.prep_layers(m.bdev[0], *targs, use_kernel=True)
    got = banded._launch_all(m.bplan, m.bdev, tab, targs[0], kw,
                             far_full_res, index, {})
    want = banded.plain_banded_extinction(m.bplan, m.bdev, *targs,
                                          far_full_res=far_full_res, **kw)
    assert torch.equal(got, want)
    assert seen["line"] >= len(m.bplan.plans)
    assert seen["shell"] == sum(b is not None for b in index["shells"])
    assert (seen["shell"] > 0) == (config == "fine")
