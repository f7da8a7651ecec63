"""The port's banded planner (opacities/fast.py make_banded_plans and its
helpers) against transit_tpu's, field for field, numpy on both sides;
and the banded tile tensors, through convert, equal to the port's own."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_conformance import make_config
from tests.test_torch_common import (bench_config, fine_grid_config,
                                     hotjupiter_config, port_config,
                                     to_numpy, torch_dtype)
from transit_tpu.model import TransitModel as JModel
from transit_tpu.opacities import fast as jfast
from transit_tpu_torch.convert import device_arrays_from_numpy
from transit_tpu_torch.io.atmosphere import read_atmosphere
from transit_tpu_torch.io.tli import read_tli, select_lines
from transit_tpu_torch.model import TransitModel
from transit_tpu_torch.opacities import fast

torch.set_num_threads(1)

CONFIGS = {"fixture": lambda: make_config("eclipse", 1e30),
           "fine": fine_grid_config, "bench": bench_config,
           "hj0.5": lambda: hotjupiter_config(0.5),
           "hj0.05": lambda: hotjupiter_config(0.05)}


def _same(a, b, where="plan"):
    """Dataclasses, lists, tuples, arrays and scalars equal field for
    field (arrays: dtype and values)."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, where
        for f in dataclasses.fields(a):
            _same(getattr(a, f.name), getattr(b, f.name),
                  f"{where}.{f.name}")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and np.array_equal(a, b), where
    else:
        assert type(a) is type(b) and a == b, where


@pytest.fixture(scope="module")
def inputs():
    """Per config: the planner's inputs from the port's readers."""
    cache = {}

    def get(name):
        if name not in cache:
            cfg = port_config(CONFIGS[name]())
            m = TransitModel(cfg, device="cpu", bands=6)
            wl, isoid, elow, gf = select_lines(read_tli(cfg.linedb),
                                               m.wns.i, m.wns.f)
            cache[name] = m, (1.0 / (np.asarray(wl) * 1e-4), isoid, elow,
                              gf)
        return cache[name]
    return get


@pytest.mark.parametrize("name,split_far,far_decimate", [
    ("fixture", True, True), ("fixture", True, False),
    ("fixture", False, True), ("fine", True, True), ("fine", True, False),
    ("fine", False, False), ("bench", True, True), ("bench", False, True),
    ("hj0.5", True, True), ("hj0.5", True, False),
    ("hj0.05", True, True), ("hj0.05", True, False)])
def test_banded_plans_equal_jax(inputs, name, split_far, far_decimate):
    m, lines = inputs(name)
    atm, mol = read_atmosphere(m.cfg.atm, m.cfg.molfile)
    bounds = fast.layer_width_bounds(atm, mol, m.iso.mass, m.iso.imol)
    jbounds = jfast.layer_width_bounds(atm, mol, m.iso.mass, m.iso.imol)
    _same(tuple(jbounds), tuple(bounds), "layer_width_bounds")
    kw = dict(wn_i=m.wns.i, dwn=m.wns.d, n_coarse=m.wns.n,
              wn_max=m.wns.f, nwidth=m.cfg.nwidth, max_bands=6,
              split_far=split_far, far_decimate=far_decimate)
    ours = fast.make_banded_plans(*lines, aL_layers=bounds[0],
                                  aDf_layers=bounds[1], **kw)
    ref = jfast.make_banded_plans(*lines, aL_layers=jbounds[0],
                                  aDf_layers=jbounds[1], **kw)
    _same(ref, ours)
    if (name, split_far, far_decimate) == ("fine", True, True):
        # The configuration reaches every plan kind the kernels take:
        shells = [fp for far in ours.far_plans if far for fp, _, _ in far]
        assert max(p.tw for p in ours.plans) == 512
        assert {p.wfn_tag for p in shells} == {"asym2", "r2"}
        assert any(p.lanes == "bins" and p.lmax == 8 for p in shells)
        assert any(p.class_tiles is not None for p in shells)
    if (name, split_far, far_decimate) == ("hj0.05", True, True):
        strides = [s for far in ours.far_plans if far for *_, s in far]
        assert sorted(set(strides)) == [1, 2, 4]


def test_model_plans_equal_jax_model(inputs):
    """Through the models: TransitModel(bands=6) of both packages on the
    fixture builds the same banded plan."""
    m, _ = inputs("fixture")
    jm = JModel(make_config("eclipse", 1e30), mode="fast", bands=6)
    _same(jm.bplan, m.bplan)
    assert m.device_tree() is m.bdev and len(m.bdev) == len(m.bplan.plans)


@pytest.mark.parametrize("npdt", [np.float64, np.float32])
def test_banded_device_arrays_from_numpy(npdt):
    """The JAX model's banded tile tensors ("classes" and "far" lists)
    through convert equal the port's own, tensor for tensor."""
    cfg = fine_grid_config()
    jm = JModel(cfg, mode="fast", bands=6, dtype=jnp.float64)
    tdt = torch_dtype(npdt)
    m = TransitModel(port_config(cfg), dtype=tdt, device="cpu", bands=6)
    conv = device_arrays_from_numpy(to_numpy(jm.bdev, npdt), dtype=tdt,
                                    device="cpu")

    def same(a, b):
        if isinstance(a, dict):
            assert a.keys() == b.keys()
            for k in a:
                same(a[k], b[k])
        elif isinstance(a, (list, tuple)):
            assert len(a) == len(b)
            for x, y in zip(a, b):
                same(x, y)
        elif a is None:
            assert b is None
        else:
            assert a.dtype == b.dtype and torch.equal(a, b)
    same(conv, m.bdev)
    assert any("classes" in fd for d in conv for fd, _ in d.get("far", []))
