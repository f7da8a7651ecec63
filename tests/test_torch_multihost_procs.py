"""A real 2-rank run of the port's multi-process bands on the CPU: two
processes (torch.multiprocessing.spawn) join a gloo group through a
FileStore under the test's tmp_path, each builds its band model of the
fixture (bands=4, float64) with balanced bounds, and runs
``MultihostForward.forward`` and ``value_and_grad`` (with the global kmax,
and without it), and the 2-rank ``make_sharded_forward`` of the
single-process model with its collective gather, forward and gradient.
Both ranks must agree, and match the single-process port model at JAX's
multi-process tolerances (tests/test_multihost.py:154-187)."""

import datetime
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from transit_tpu_torch.config import TransitConfig
from transit_tpu_torch.model import TransitModel
from transit_tpu_torch.parallel import multihost
from transit_tpu_torch.parallel.sharded import make_sharded_forward

torch.set_num_threads(1)

NPROC = 2


def _cfg() -> TransitConfig:
    """tests/test_conformance.make_config("eclipse", 1e30), without
    importing the JAX package in the workers."""
    import os
    fix = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixtures")
    return TransitConfig(
        atm=f"{fix}/test.atm", linedb=f"{fix}/test.tli",
        csfile=f"{fix}/test_cia.dat", molfile=f"{fix}/molecules.dat",
        wnlow=2000.0, wnhigh=2100.0, wndelt=1.0, wnosamp=216, wnfct=1.0,
        ndop=15, nlor=15, nwidth=20.0, ethreshold=1e-8,
        solution="eclipse", toomuch=1e30)


def _obs(n: int, peak: float):
    """A deterministic observation for the loss (multihost_worker.py)."""
    return torch.as_tensor(0.5 * peak * (1.0 + 0.1 * np.sin(
        np.linspace(0.0, 6.0, n))))


def _loss_fn(obs):
    return lambda band_spec, blk: torch.sum(
        (band_spec - obs[blk[0]:blk[1]]) ** 2)


def _weights(n: int):
    return torch.linspace(0.5, 2.0, n, dtype=torch.float64)


def _worker(rank: int, store: str, out: str):
    torch.set_num_threads(1)
    multihost.initialize(f"file://{store}", NPROC, rank,
                         timeout=datetime.timedelta(seconds=120))
    try:
        cfg = _cfg()
        res = {}
        for mode in ("exact", "local"):
            run = multihost.MultihostForward(
                cfg, bands=4, dtype=torch.float64, device="cpu",
                exact_ethresh=mode == "exact")
            m = run.model
            T, q = torch.as_tensor(m.atm.temp), torch.as_tensor(m.atm.q)
            res[f"spec_{mode}"] = run.forward(T, q).numpy()
        obs = _obs(run.model.wns_global.n, float(res["spec_exact"].max()))
        run = multihost.MultihostForward(cfg, bands=4, dtype=torch.float64,
                                         device="cpu")
        loss, (gt, gq) = run.value_and_grad(_loss_fn(obs), T, q)
        res.update(loss=loss.numpy(), grad_t=gt.numpy(), grad_q=gq.numpy(),
                   bounds=run.bounds, block=np.asarray(run.block),
                   n_local_lines=run.n_local_lines)
        single = TransitModel(cfg, mode="fast", dtype=torch.float64,
                              device="cpu", bands=4)
        step = make_sharded_forward(single, group=dist.group.WORLD)
        Tg, qg = T.clone().requires_grad_(), q.clone().requires_grad_()
        spec = step(Tg, qg)
        g = torch.autograd.grad(torch.dot(_weights(spec.shape[0]), spec),
                                (Tg, qg))
        res.update(coll=spec.detach().numpy(), coll_t=g[0].numpy(),
                   coll_q=g[1].numpy())
        np.savez(f"{out}.p{rank}.npz", **res)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both ranks' results; a rank that fails raises here, and the run is
    killed and fails after 300 s."""
    d = tmp_path_factory.mktemp("mh")
    ctx = mp.spawn(_worker, args=(str(d / "store"), str(d / "r")),
                   nprocs=NPROC, join=False)
    deadline = time.monotonic() + 300.0
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail("the 2-rank run did not finish in 300 s")
    assert not any(p.is_alive() for p in ctx.processes)
    return [dict(np.load(d / f"r.p{r}.npz")) for r in range(NPROC)]


@pytest.fixture(scope="module")
def single():
    m = TransitModel(_cfg(), mode="fast", dtype=torch.float64, device="cpu",
                     bands=4)
    return m, torch.as_tensor(m.atm.temp), torch.as_tensor(m.atm.q)


def _grads(f, T, q, loss):
    Tg, qg = T.clone().requires_grad_(), q.clone().requires_grad_()
    val = loss(f(Tg, qg))
    return (val.detach().numpy(),
            *(g.numpy() for g in torch.autograd.grad(val, (Tg, qg))))


def _close_grad(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=np.abs(want).max() * 1e-8)


def test_forward_matches_single_process(ranks, single):
    """Both ranks hold the same gathered spectrum, the single model's
    (rtol 1e-10, JAX's bound); each band's own kmax moves it by no
    more than the ethresh level (rtol 1e-5); the bands are balanced."""
    m, T, q = single
    ref = m.forward(T, q).numpy()
    for r in ranks:
        assert r["bounds"].shape == (NPROC + 1,)
        np.testing.assert_array_equal(r["spec_exact"], ranks[0]["spec_exact"])
        np.testing.assert_allclose(r["spec_exact"], ref, rtol=1e-10, atol=0)
        np.testing.assert_allclose(r["spec_local"], ref, rtol=1e-5, atol=0)
    counts = [int(r["n_local_lines"]) for r in ranks]
    assert max(counts) <= 2 * min(counts), counts


def test_value_and_grad_matches_single_process(ranks, single):
    """The summed loss and gradients, equal on both ranks, against the
    single model's: loss rtol 1e-8, gradients rtol 1e-6 and atol 1e-8 of
    their max (JAX's bounds)."""
    m, T, q = single
    obs = _obs(m.wns.n, float(ranks[0]["spec_exact"].max()))
    loss, gt, gq = _grads(m.forward, T, q,
                          lambda s: _loss_fn(obs)(s, (0, m.wns.n)))
    for r in ranks:
        for k in ("loss", "grad_t", "grad_q"):
            np.testing.assert_array_equal(r[k], ranks[0][k])
        np.testing.assert_allclose(r["loss"], loss, rtol=1e-8)
        _close_grad(r["grad_t"], gt)
        _close_grad(r["grad_q"], gq)


def test_collective_step_matches_local_assembly(ranks, single):
    """The 2-rank make_sharded_forward (all-gather over the group, the
    gradient summed over the ranks) against one process's 2 shards by
    step.local, assembled: the spectrum bit for bit, the gradient of
    vdot(w, spectrum) to 1e-12."""
    m, T, q = single
    step = make_sharded_forward(m, nshard=NPROC)
    _, gt, gq = _grads(
        lambda t, qq: step.assemble([step.local(s, t, qq)
                                     for s in range(NPROC)]), T, q,
        lambda s: torch.dot(_weights(s.shape[0]), s))
    want = step.assemble([step.local(s, T, q) for s in range(NPROC)])
    for r in ranks:
        np.testing.assert_array_equal(r["coll"], want.numpy())
        np.testing.assert_allclose(r["coll_t"], gt, rtol=1e-12, atol=0)
        np.testing.assert_allclose(r["coll_q"], gq, rtol=1e-12, atol=0)
