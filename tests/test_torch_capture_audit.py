"""The retrieval step makes no host transfer once warm: the condition for
capturing it as a CUDA graph (TransitModel.make_forward).

After one warm-up call, a forward and its backward must create no tensor
from host data (``torch.as_tensor``, ``torch.tensor`` and
``torch.from_numpy`` of anything but a tensor) and read no value to the
host (``aten._local_scalar_dense``, behind ``.item()``, ``float()``,
``int()`` and ``bool()`` of a tensor; ``nonzero`` and ``masked_select``,
whose output size the host must read; ``Tensor.tolist``, ``.numpy`` and
``.cpu``).  The audit covers every torch op of the step (``partition``,
``_profiles``, ``geometry``, ``banded.band_tables``,
``lbl.layer_groups``, ``grid_extinction``, ``_assemble``, their
backwards) except the plain versions of the kernels, which run only on
the CPU (the card launches the kernels in their place): the line-tile
and profile-scatter functions, their kmax scans and their VJPs.  Paths:
the eclipse main path (bands=6) and its batched step, the unbanded
plan, transit with hydrostatic radii (and with ``transparent``),
eclipse with hydrostatic radii, exact mode and grid mode; the sharded
step (parallel/sharded.py, 2 shards through ``step.local`` and
``step.assemble``) of the main path, the unbanded plan and grid mode;
and the band step of one process (parallel/multihost.py,
``MultihostForward``: ``local_spectrum`` and ``value_and_grad`` at the
band's external kmax; the kmax's host collective runs only with several
processes), on the conformance fixture in float32.  Port only."""

import functools

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from tests.test_conformance import GOLD, make_config
from tests.test_torch_common import port_config
from transit_tpu_torch.model import TransitModel
from transit_tpu_torch.opacities import banded, kernel_lbl, kernel_profile
from transit_tpu_torch.parallel.multihost import MultihostForward
from transit_tpu_torch.parallel.sharded import make_sharded_forward

torch.set_num_threads(1)

HYDRO = dict(gsurf=980.0, refpress=1.0, refradius=92000.0)
# Ops whose result the host must read: item() and its kin, and the ops
# whose output size depends on the data.
HOST_READS = ("_local_scalar_dense", "nonzero", "masked_select")


class HostAudit(TorchDispatchMode):
    """Records every host transfer of the code it runs around, with the
    innermost line of the port that made it (``found``), inside
    ``with`` and outside the code that ``paused`` wraps (a depth: the
    kernels' plain versions)."""

    def __init__(self):
        super().__init__()
        self.found = []
        self.paused = 1            # recording only inside ``with``

    def __enter__(self):
        self.paused -= 1
        return super().__enter__()

    def __exit__(self, *exc):
        self.paused += 1
        return super().__exit__(*exc)

    def record(self, what):
        if self.paused:
            return
        import traceback
        frames = [f for f in traceback.extract_stack()
                  if "transit_tpu_torch" in f.filename]
        site = (f"{frames[-1].filename.split('transit_tpu_torch')[-1]}:"
                f"{frames[-1].lineno}" if frames else "?")
        self.found.append(f"{what} at transit_tpu_torch{site}")

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket.__name__ in HOST_READS:
            self.record(f"aten.{func.overloadpacket.__name__}")
        return func(*args, **(kwargs or {}))


def paused(audit, fn):
    @functools.wraps(fn)
    def run(*a, **k):
        audit.paused += 1
        try:
            return fn(*a, **k)
        finally:
            audit.paused -= 1
    return run


@pytest.fixture
def audit(monkeypatch):
    """A HostAudit with the host-data constructors and the host reads of
    Tensor patched to report to it, and the plain versions of the
    kernels paused."""
    a = HostAudit()
    for name in ("as_tensor", "tensor", "from_numpy"):
        fn = getattr(torch, name)

        def made(data, *args, _fn=fn, _name=name, **kw):
            if not isinstance(data, torch.Tensor):
                a.record(f"torch.{_name}({type(data).__name__})")
            return _fn(data, *args, **kw)
        monkeypatch.setattr(torch, name, made)
    for name in ("tolist", "numpy", "cpu"):
        fn = getattr(torch.Tensor, name)

        def read(self, *args, _fn=fn, _name=name, **kw):
            a.record(f"Tensor.{_name}")
            return _fn(self, *args, **kw)
        monkeypatch.setattr(torch.Tensor, name, read)
    for cls in (banded.BandedOp, kernel_lbl.TilesOp):
        for name in ("kmax", "forward", "backward"):
            monkeypatch.setattr(cls, name, paused(a, getattr(cls, name)))
    for name in ("profile_scatter_plain", "profile_scatter_plain_vjp"):
        monkeypatch.setattr(kernel_profile, name,
                            paused(a, getattr(kernel_profile, name)))
    monkeypatch.setattr(banded, "band_kmax", paused(a, banded.band_kmax))
    return a


def step(fn, T, q):
    """A forward of ``fn`` and its backward in T and q."""
    T = T.clone().requires_grad_(True)
    q = q.clone().requires_grad_(True)
    return torch.autograd.grad(fn(T, q).sum(), (T, q))


def step_fn(case: str, m):
    """The case's step (T, q) -> spectrum: the model's forward
    (forward_batch for the batch), or 2 shards through step.local, then
    step.assemble."""
    if case.startswith("sharded"):
        st = make_sharded_forward(m, nshard=2)
        return lambda T, q: st.assemble([st.local(s, T, q)
                                         for s in range(st.nshard)])
    return m.forward_batch if case == "main_batch" else m.forward


def config(case: str):
    case = case.removeprefix("sharded_")
    if case == "grid":
        cfg = make_config("eclipse", 1e30)
        cfg.tlow, cfg.thigh, cfg.tempdelt = 1000.0, 2000.0, 100.0
        cfg.opacityfile = f"{GOLD}/ref_opacity_grid.bin"
        return cfg
    cfg = make_config("transit" if case.startswith("transit") else
                      "eclipse", 1e30)
    if case.startswith("transit") or case == "eclipse_hydro":
        for k, v in HYDRO.items():
            setattr(cfg, k, v)
    cfg.transparent = case == "transit_transparent"
    if case == "exact":
        cfg.wnhigh = 2040.0
    return cfg


CASES = {"main": dict(mode="fast", bands=6),
         "main_batch": dict(mode="fast", bands=6),
         "unbanded": dict(mode="fast"),
         "transit": dict(mode="fast", bands=6),
         "transit_transparent": dict(mode="fast", bands=6),
         "eclipse_hydro": dict(mode="fast", bands=6),
         "exact": dict(mode="exact"),
         "grid": dict(mode="fast"),
         "sharded_main": dict(mode="fast", bands=6),
         "sharded_unbanded": dict(mode="fast"),
         "sharded_grid": dict(mode="fast")}


@pytest.mark.parametrize("case", list(CASES))
def test_step_makes_no_host_transfer(case, audit):
    m = TransitModel(port_config(config(case)), dtype=torch.float32,
                     device="cpu", **CASES[case])
    assert m.hydrostatic == (case.startswith("transit") or
                             case == "eclipse_hydro")
    assert (m.ogrid is not None) == case.endswith("grid")
    T = torch.tensor(m.atm.temp, dtype=torch.float32)
    q = torch.tensor(m.atm.q, dtype=torch.float32)
    batch = case == "main_batch"
    if batch:
        T = torch.stack([T, T + 40.0])
        q = torch.stack([q, q * 1.1])
    fn = step_fn(case, m)
    step(fn, T, q)                          # warm-up
    with audit:
        gT, gq = step(fn, T + 10.0, q)
    assert torch.isfinite(gT).all() and float(gT.abs().max()) > 0
    assert audit.found == [], "\n".join(sorted(set(audit.found)))


def test_band_step_makes_no_host_transfer(audit):
    """The band step of one process at its external kmax (the band's
    own: line_kmax over its lines): local_spectrum and value_and_grad of
    the band spectrum's sum."""
    run = MultihostForward(port_config(config("main")), bands=6,
                           dtype=torch.float32, device="cpu")
    assert run.nproc == 1 and run.exact_ethresh
    T = torch.tensor(run.model.atm.temp, dtype=torch.float32)
    q = torch.tensor(run.model.atm.q, dtype=torch.float32)

    def loss(spec, block):
        return spec.sum()
    run.local_spectrum(T, q)                # warm-up
    run.value_and_grad(loss, T, q)
    with audit:
        spec = run.local_spectrum(T + 10.0, q)
        val, (gT, gq) = run.value_and_grad(loss, T + 10.0, q)
    assert spec.shape == (run.model.wns.n,) and torch.isfinite(val)
    assert torch.isfinite(gT).all() and float(gT.abs().max()) > 0
    assert audit.found == [], "\n".join(sorted(set(audit.found)))


def test_audit_sees_host_transfers(audit):
    """The audit catches each kind it looks for."""
    x = torch.arange(4.0)
    with audit:
        torch.as_tensor(np.ones(3))
        torch.tensor(1.0)
        float(x.sum())
        x.nonzero()
        x.tolist()
    kinds = [f.split(" at ")[0] for f in audit.found]
    assert kinds == ["torch.as_tensor(ndarray)", "torch.tensor(float)",
                     "aten._local_scalar_dense", "aten.nonzero",
                     "Tensor.tolist"], kinds
