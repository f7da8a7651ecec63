"""The port's wavenumber sharding (transit_tpu_torch.parallel.sharded)
against transit_tpu.parallel.sharded on the CPU: the block costs and the
LPT assignment equal JAX's, and the port's 4 shards, each run through
``step.local`` and assembled, give JAX's sharded spectrum (a 4-device
mesh of the conftest's virtual CPU devices) and the port's single model,
float64, at JAX's own tolerances (tests/test_sharded.py)."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from tests.test_conformance import GOLD, make_config
from tests.test_opacity_grid import grid_config
from transit_tpu.model import TransitModel as JModel
from transit_tpu.parallel import sharded as jsharded
from transit_tpu_torch.config import TransitConfig
from transit_tpu_torch.model import TransitModel
from transit_tpu_torch.parallel import sharded

torch.set_num_threads(1)

NSHARD = 4


def _mesh():
    return Mesh(np.array(jax.devices()[:NSHARD]).reshape(1, NSHARD),
                ("batch", "wn"))


def _port(jcfg, bands):
    return TransitModel(TransitConfig(**dataclasses.asdict(jcfg)),
                        mode="fast", dtype=torch.float64, device="cpu",
                        bands=bands)


def _local_assembled(step, T, q):
    return step.assemble([step.local(s, T, q) for s in range(step.nshard)])


def test_block_costs_and_balance_equal_jax():
    """The synthetic clustered case of tests/test_sharded.py:78-106: the
    costs and the assignment equal JAX's to the index, the loads within
    15% of each other where contiguous spans are > 3x apart."""

    @dataclasses.dataclass
    class FakePlan:
        tw: int
        ntiles: int
        tile_count: np.ndarray

    rng = np.random.default_rng(7)
    ntiles = 256
    count = np.where(np.arange(ntiles) < 64,
                     rng.integers(200, 400, ntiles),
                     rng.integers(10, 60, ntiles)).astype(np.int64)
    sp = FakePlan(tw=8, ntiles=ntiles, tile_count=count)
    costs = sharded._block_costs([(sp, 100.0)], ntiles, 8)
    np.testing.assert_array_equal(
        costs, jsharded._block_costs([(sp, 100.0)], ntiles, 8))
    blocks, loads = sharded._balance_blocks(costs, 8)
    jb, jl = jsharded._balance_blocks(costs, 8)
    np.testing.assert_array_equal(blocks, jb)
    np.testing.assert_array_equal(loads, jl)
    assert sorted(blocks.reshape(-1).tolist()) == list(range(ntiles))
    assert loads.max() <= 1.15 * loads.min(), loads
    contiguous = costs.reshape(8, -1).sum(axis=1)
    assert contiguous.max() > 3.0 * contiguous.min()


def test_tile_tensors_for_equal_jax():
    """A permuted tile list with padding slots: the line tensors, the
    mask (empty on padding) and the global indices equal JAX's."""
    jm = JModel(make_config("eclipse", 1e30), mode="fast")
    sp = jm.fplan
    tiles = np.array([3, 0, sp.ntiles + 1, 5, sp.ntiles])
    want = jsharded._tile_tensors_for(sp, tiles, jnp.float64)
    got = sharded._tile_tensors_for(sp, tiles, torch.float64, "cpu")
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert not got["mask"][2].any() and not got["mask"][4].any()


@pytest.mark.parametrize("bands,balance", [(0, True), (4, True),
                                           (4, False)])
def test_eval_stats_equal_jax(bands, balance):
    """The block assignment and loads of a 4-shard step equal those of
    JAX's make_sharded_forward on a 4-device mesh (balanced by LPT, or
    contiguous equal spans)."""
    jc = make_config("eclipse", 1e30)
    want = jsharded.make_sharded_forward(
        JModel(jc, mode="fast", bands=bands), _mesh(),
        balance=balance).eval_stats
    got = sharded.make_sharded_forward(_port(jc, bands), nshard=NSHARD,
                                       balance=balance).eval_stats
    for k in ("blocks", "actual_evals", "block_costs"):
        np.testing.assert_array_equal(got[k], want[k])
    assert sorted(got["blocks"].reshape(-1).tolist()) == \
        list(range(got["block_costs"].shape[0]))


def check_spectrum(solution: str, bands: int, rtol: float):
    """Float64, the file atmosphere: the port's shards assembled against
    JAX's sharded step and against the port's single model, at JAX's
    own tolerances (sharded vs single, tests/test_sharded.py); the
    step's own call equals the local assembly."""
    jc = make_config(solution, 1e30)
    jm = JModel(jc, mode="fast", bands=bands)
    want = np.asarray(jsharded.make_sharded_forward(jm, _mesh())(
        jnp.asarray(jm.atm.temp), jnp.asarray(jm.atm.q)))
    m = _port(jc, bands)
    T, q = torch.as_tensor(m.atm.temp), torch.as_tensor(m.atm.q)
    step = sharded.make_sharded_forward(m, nshard=NSHARD)
    parts = [step.local(s, T, q) for s in range(NSHARD)]
    assert all(p.shape == (step.span,) for p in parts)
    got = step.assemble(parts)
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=0)
    np.testing.assert_allclose(got.numpy(), m.forward(T, q).numpy(),
                               rtol=rtol, atol=0)
    assert torch.equal(step(T, q), got)


@pytest.mark.parametrize("bands,rtol", [(0, 1e-11), (6, 1e-10)])
def test_sharded_eclipse_matches_jax_and_single(bands, rtol):
    """Eclipse (transit: tests/test_torch_sharded_transit.py)."""
    check_spectrum("eclipse", bands, rtol)


def test_grid_mode_sharded_matches_full_grid_model():
    """Grid mode: 4 contiguous spans of the grid's wavenumbers against
    the grid model's forward (pointwise in wavenumber)."""
    cfg = dataclasses.asdict(grid_config())
    cfg["opacityfile"] = os.path.join(GOLD, "ref_opacity_grid.bin")
    m = TransitModel(TransitConfig(**cfg), dtype=torch.float64,
                     device="cpu")
    assert m.ogrid is not None
    T, q = torch.as_tensor(m.atm.temp), torch.as_tensor(m.atm.q)
    step = sharded.make_sharded_forward(m, nshard=NSHARD)
    assert step.eval_stats is None and step.span == -(-m.wns.n // NSHARD)
    np.testing.assert_allclose(_local_assembled(step, T, q).numpy(),
                               m.forward(T, q).numpy(), rtol=1e-12, atol=0)
