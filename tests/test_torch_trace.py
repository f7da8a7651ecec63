"""The port's layer spans and layer maps (transit_tpu_torch/utils/log.py):
the span store (nesting, parents, node ranges, self time; nothing stored
when no map is recorded and no profiler runs), the spans' coverage of
every op of a forward and its backward (exact mode, in one chunk and in
chunks, and the banded main path, one profile and a batch), the
attribution of a replay's device events (:func:`log.attribute`) and the
cost of an unobserved span.  On the conformance fixture in float32,
port only: no JAX program runs.  The card's graphs are tested in
tests/test_torch_cuda.py (``-k layer_map``)."""

import functools
import statistics
import time

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from tests.test_conformance import make_config
from tests.test_torch_common import port_config
from transit_tpu_torch.model import TransitModel
from transit_tpu_torch.opacities import lbl
from transit_tpu_torch.utils import log
from transit_tpu_torch.utils.log import span

torch.set_num_threads(1)


class OpCount(TorchDispatchMode):
    """Counts the ops that are not views (stand-ins for a graph's
    device-work nodes) and, for each, the innermost open span's handle
    (``log._stack``'s top: a recorded span, or a name, or None)."""

    def __init__(self):
        super().__init__()
        self.n, self.ops = 0, []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not func.is_view:
            self.n += 1
            self.ops.append((func.overloadpacket.__name__,
                             log._stack[-1] if log._stack else None))
        return func(*args, **(kwargs or {}))

    def counter(self):
        """A node count from now on (a backward graph's own)."""
        start = self.n
        return lambda: self.n - start


@pytest.fixture(autouse=True)
def clean_store():
    """Each test's maps go to a store of its own."""
    maps, setup = dict(log.MAPS), dict(log.SETUP)
    log.MAPS.clear()
    yield
    assert log._stack == [] and log._recorder is None
    log.MAPS.clear()
    log.MAPS.update(maps)
    log.SETUP.clear()
    log.SETUP.update(setup)


def toy_step(x, y):
    with span("step"):
        with span("a"):
            u = x * 2.0 + y
        with span("b"):
            with span("b1"):
                v = u.sin()
            with span("b2"):
                w = (v * v).sum()
    return w


def test_span_store_nesting_parents_and_nodes():
    """A recorded forward: each span's parent, depth and node range
    [first, last), the kernel notes, and the map stored by key."""
    ops = OpCount()
    x = torch.ones(3)
    with ops, log.MapRecorder(("toy", "x", "fwd"), lambda: ops.n) as rec:
        toy_step(x, x)
        log.launched("toy_kernel")
    m = log.MAPS[("toy", "x", "fwd")]
    assert m is rec.map and m.nodes == ops.n == 5
    assert m.spans == [("step", -1, 0, 0, 5), ("a", 0, 1, 0, 2),
                       ("b", 0, 1, 2, 5), ("b1", 2, 2, 2, 3),
                       ("b2", 2, 2, 3, 5)]
    assert m.kernels == [(4, "toy_kernel")]
    assert log._stack == [] and rec.seconds > 0


class EveryOtherIsAnEvent:
    """A node count whose graph adds an event node after each op: count()
    gives all nodes, work(c) the ops among the first c."""

    def __init__(self, ops):
        self.ops = ops

    def __call__(self):
        return 2 * self.ops.n

    def work(self, c):
        return (c + 1) // 2


def test_map_counts_turned_into_device_work():
    """A count with ``work`` (step_graph._NodeCount's): the map's node
    ranges, kernel nodes and node total are of device work."""
    ops = OpCount()
    x = torch.ones(3)
    with ops, log.MapRecorder(("toy", "x", "fwd"),
                              EveryOtherIsAnEvent(ops)):
        toy_step(x, x)
        log.launched("toy_kernel")
    m = log.MAPS[("toy", "x", "fwd")]
    assert m.nodes == 5 and m.kernels == [(4, "toy_kernel")]
    assert m.spans[2] == ("b", 0, 1, 2, 5)


def test_backward_map_follows_the_forward_spans():
    """The backward's prehooks open <span>.bwd for the spans that created
    each autograd node, nested as in the forward; the map ends when every
    input has its gradient; self time adds up to the window."""
    ops = OpCount()
    x = torch.ones(3, requires_grad=True)
    y = torch.ones(3, requires_grad=True)
    with ops:
        with log.MapRecorder(("toy", "xy", "fwd"), lambda: ops.n,
                             tags=True) as fwd:
            out = toy_step(x, y)
        bwd = log.BackwardMap(fwd, (out,), (x, y), ("toy", "xy", "bwd"),
                              ops.counter)
        gx, gy = torch.autograd.grad(out, (x, y))
        bwd.close()
    assert torch.allclose(gx, 2 * torch.sin(2 * x + 1).mul(
        2 * torch.cos(2 * x + 1)))
    m = log.MAPS[("toy", "xy", "bwd")]
    names = [s[0] for s in m.spans]
    assert names[:4] == ["step.bwd", "b.bwd", "b2.bwd", "b1.bwd"]
    assert "a.bwd" in names and m.spans[0][3:] == (0, m.nodes)
    paths = {}
    for name, parent, depth, a, b in m.spans:
        paths[name] = (names[parent] if parent >= 0 else None, depth)
    assert paths["b1.bwd"] == ("b.bwd", 2) and paths["a.bwd"] == (
        "step.bwd", 1)
    # Events named by their node, 1 ms each:
    ev = [(f"op{i}", i * 1e-3, (i + 1) * 1e-3) for i in range(m.nodes)]
    m.kernels.append((m.nodes - 1, f"op{m.nodes - 1}"))
    got = log.attribute(m, ev)
    s = got["spans"]
    assert s[("step.bwd",)]["ms"] == pytest.approx(got["ms"] -
                                                   got["unattributed_ms"])
    total_self = sum(v["self_ms"] for v in s.values())
    assert total_self + got["unattributed_ms"] == pytest.approx(m.nodes)
    b = s[("step.bwd", "b.bwd")]
    assert b["ms"] == pytest.approx(
        b["self_ms"] + s[("step.bwd", "b.bwd", "b1.bwd")]["ms"] +
        s[("step.bwd", "b.bwd", "b2.bwd")]["ms"])


def test_graphed_step_recording_on_cpu(monkeypatch):
    """step_graph._Recording, through which GraphedStep captures a
    signature, with the capture faked on the CPU: the warm-up calls are
    timed, the captured call records the forward's map and hooks the
    backward's, and the set-up's host spans are stored."""
    from transit_tpu_torch import step_graph
    ops = OpCount()
    monkeypatch.setattr(step_graph, "_NodeCount", ops.counter)
    sig = "x (3,) grad, y (3,) grad"
    rec = step_graph._Recording(toy_step, "make_forward", sig)
    x = torch.ones(3, requires_grad=True)
    y = torch.ones(3, requires_grad=True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    with ops:
        for _ in range(2):
            torch.autograd.grad(rec(x, y), (x, y))
        assert log.MAPS == {}
        monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                            lambda: True)
        torch.autograd.grad(rec(x, y), (x, y))
    rec.done()
    assert set(log.MAPS) == {("make_forward", sig, "fwd"),
                             ("make_forward", sig, "bwd")}
    assert log.MAPS[("make_forward", sig, "bwd")].spans[0][0] == "step.bwd"
    spans = log.SETUP[("make_forward", sig)]
    assert [n for n, _ in spans] == ["warmup", "warmup", "capture",
                                     "layer_map"]
    assert all(s > 0 for _, s in spans)


def test_unobserved_span_stores_nothing():
    """Without a recorder or a profiler a span is a push and a pop of its
    name: one span object per name, nothing stored."""
    assert span("a") is span("a")
    with span("a"):
        with span("b"):
            assert log._stack == ["a", "b"]
    assert log._stack == [] and log.MAPS == {}
    log.launched("line_tile_kernel")
    assert log.MAPS == {}


def test_spans_under_the_profiler():
    """Eager, under torch.profiler, a span is record_function
    ``transit.<name>``; so is a Timers stage."""
    t = log.Timers()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with span("outer"):
            with t.stage("inner"):
                torch.ones(4).sum()
    names = {e.name for e in prof.events()}
    assert {"transit.outer", "transit.inner"} <= names
    assert [n for n, _ in t.records] == ["inner"]


# ---------------------------------------------------------------------
# Coverage of the step's ops by leaf spans

@functools.lru_cache(maxsize=None)
def fixture_model(mode: str):
    cfg = make_config("eclipse", 1e30)
    if mode == "exact":
        cfg.wnhigh = 2040.0
    kw = dict(mode="exact") if mode == "exact" else dict(mode="fast",
                                                         bands=6)
    return TransitModel(port_config(cfg), dtype=torch.float32,
                        device="cpu", **kw)


def leaf_misses(ops, recorders) -> list:
    """The ops whose innermost span is not a leaf (a span no other span
    lies in), or that run under no span."""
    parents = {id(r): {s[1] for s in r.spans} for r in recorders}
    miss = []
    for name, top in ops:
        if not isinstance(top, log._Recorded):
            miss.append(f"{name} under {top!r}")
        elif top.index in parents[id(top.rec)]:
            miss.append(f"{name} under {top.name}")
    return miss


@pytest.mark.parametrize("case", ["exact", "exact_chunks", "main",
                                  "main_batch"])
def test_every_op_runs_under_a_leaf_span(case, monkeypatch):
    """Every op (views aside: they make no device work) of a forward and
    of its backward runs under a leaf span: the forward's recorded spans,
    and the backward's <span>.bwd and the custom Functions' own spans."""
    m = fixture_model("fast" if case.startswith("main") else "exact")
    if case == "exact_chunks":
        monkeypatch.setitem(lbl.GROUP_ROW_ENTRIES, "cpu",
                            7 * max(m.plan.n_lines, m.plan.n_groups))
        assert lbl.chunk_rows(m.plan, m.device, m.wns.n) == 7
    T = torch.tensor(m.atm.temp, dtype=torch.float32)
    q = torch.tensor(m.atm.q, dtype=torch.float32)
    if case == "main_batch":
        T, q = torch.stack([T, T + 40.0]), torch.stack([q, q * 1.1])
    step = m.make_forward()
    T.requires_grad_(True)
    q.requires_grad_(True)
    ones = torch.ones(T.shape[:-1] + (m.wns.n,))
    ops = OpCount()
    with ops:
        with log.MapRecorder(("make_forward", case, "fwd"), lambda: ops.n,
                             tags=True) as fwd:
            out = step(T, q)
        bwd = log.BackwardMap(fwd, (out,), (T, q),
                              ("make_forward", case, "bwd"), ops.counter)
        gT, gq = torch.autograd.grad(out, (T, q), ones)
        bwd.close()
    assert torch.isfinite(gT).all() and float(gT.abs().max()) > 0
    names = {s[0] for r in (fwd, bwd.rec) for s in r.spans}
    want = {"step", "densities", "partition", "line_extinction",
            "assembly", "cia", "tau", "emission", "step.bwd",
            "assembly.bwd", "line_extinction.bwd"}
    if case.startswith("exact"):
        want |= {"groups.strengths", "groups.coadd", "groups.doppler",
                 "scatter", "scatter.bwd"}
    if case == "exact_chunks":
        want |= {"chunk", "groups.recompute", "groups.vjp"}
    if case.startswith("main"):
        want |= {"tables", "kmax", "line_tiles", "line_tiles.bwd"}
    assert want <= names, want - names
    miss = leaf_misses(ops.ops, (fwd, bwd.rec))
    assert miss == [], "\n".join(sorted(set(miss)))


# ---------------------------------------------------------------------
# attribute()

def synthetic_map():
    """A replay of 8 nodes: step [0, 8) with a [0, 3) holding the port
    kernel k_a at 1, and b [3, 7) with k_b at 5; node 7 is step's own."""
    return log.LayerMap(
        spans=[("step", -1, 0, 0, 8), ("a", 0, 1, 0, 3),
               ("b", 0, 1, 3, 7)],
        kernels=[(1, "k_a"), (5, "k_b")], nodes=8)


def events(names, t0=0.0):
    """Events of 1 ms each with 0.5 ms gaps, in order."""
    return [(n, t0 + i * 1.5e-3, t0 + i * 1.5e-3 + 1e-3)
            for i, n in enumerate(names)]


REPLAY = ["fill", "void k_a<1>(float*)", "add", "Memcpy DtoD", "mul",
          "void k_b(int)", "sum", "Memset (Device)"]


def test_attribute_finds_the_replay_between_copies_and_the_loss():
    ev = events(["Memcpy DtoD (Device -> Device)"] * 2 + REPLAY +
                ["Memcpy DtoD (Device -> Device)", "pow", "reduce"])
    got = log.attribute(synthetic_map(), ev)
    assert got["window"] == [2, 10]
    s = got["spans"]
    assert s[("step",)]["ms"] == pytest.approx(8.0)
    assert s[("step",)]["self_ms"] == pytest.approx(1.0)
    assert s[("step", "a")]["ms"] == pytest.approx(3.0)
    assert s[("step", "b")]["kernels"] == 3        # the copy not counted
    assert s[("step",)]["kernels"] == 6
    assert got["unattributed_ms"] == 0.0 and got["port_ms"] == \
        pytest.approx(2.0)
    a0, a1 = s[("step", "a")]["intervals"][0]
    assert (a0, a1) == pytest.approx((ev[2][1], ev[4][2]))


@pytest.mark.parametrize("case", ["shifted", "missing", "twice"])
def test_attribute_refuses_to_guess(case):
    names = list(REPLAY)
    if case == "shifted":            # a node more before k_b than mapped
        names.insert(4, "extra")
        names.pop()
    elif case == "missing":
        names[5] = "void other_kernel(int)"
    else:
        names = names + ["copy"] + names
    assert log.attribute(synthetic_map(), events(["Memcpy"] + names)) \
        is None


def test_unobserved_span_costs_under_2_us():
    """The median cost of an unobserved span's enter and exit, over 100
    batches of 100 spans."""
    s = span("cost")
    per = []
    for _ in range(100):
        t = time.perf_counter()
        for _ in range(100):
            with s:
                pass
        per.append((time.perf_counter() - t) / 100)
    assert statistics.median(per) < 2e-6


# ---------------------------------------------------------------------
# step_graph._NodeCount against a stand-in of libcuda

MOCK_LIBCUDA = r"""
#include <cstddef>
#include <vector>
struct Node { int type; };
static std::vector<Node *> nodes;
static int capturing = 1;
extern "C" {
void mock_add(int type) { nodes.push_back(new Node{type}); }
void mock_capture_ends(void) { capturing = 0; }
int cuStreamGetCaptureInfo_v3(void *, int *status, void *, void **graph,
                              void ***deps, void **, size_t *n) {
  static void *leaf[1];
  *status = capturing;
  *graph = (void *)&nodes;
  leaf[0] = nodes.empty() ? nullptr : nodes.back();
  *deps = leaf;
  *n = nodes.empty() ? 0 : 1;
  return 0;
}
int cuGraphGetNodes(void *, void **buf, size_t *n) {
  if (buf) {
    size_t m = *n < nodes.size() ? *n : nodes.size();
    for (size_t i = 0; i < m; i++) buf[i] = nodes[i];
    *n = m;
  } else {
    *n = nodes.size();
  }
  return 0;
}
int cuGraphNodeGetType(void *node, int *t) {
  *t = ((Node *)node)->type;
  return 0;
}
}
"""


def test_node_count_types_each_node_once(tmp_path, monkeypatch):
    """_NodeCount, the node count a layer map records while a graph is
    captured, on a stand-in of libcuda's capture and graph queries (a
    C++ library with their signatures): counts of every kind of node
    during the capture, then, as the map closes, each count turned into
    the kernel, memcpy and memset nodes among it (not event or empty
    nodes), every node typed once; no count outside a capture."""
    import ctypes
    import subprocess
    from transit_tpu_torch import step_graph
    from transit_tpu_torch.opacities._build import cxx_path
    src, lib_path = tmp_path / "mock.cpp", tmp_path / "libmockcuda.so"
    src.write_text(MOCK_LIBCUDA)
    subprocess.run([cxx_path(), "-O1", "-shared", "-fPIC", "-o",
                    str(lib_path), str(src)], check=True)
    lib = ctypes.CDLL(str(lib_path))
    real = ctypes.CDLL
    monkeypatch.setattr(ctypes, "CDLL", lambda name, *a, **k: lib
                        if name == "libcuda.so.1" else real(name, *a, **k))
    monkeypatch.setattr(step_graph, "_LIBCUDA", [])
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: type("S", (), {"cuda_stream": 0})())
    typed = []
    kind = step_graph._libcuda()[3]
    monkeypatch.setattr(step_graph, "_LIBCUDA", [step_graph._LIBCUDA[0][:3] + (
        lambda node, t: typed.append(node) or kind(node, t),)])
    count, want, seen = step_graph._NodeCount(), 0, []
    for i in range(2500):
        k = (0, 1, 2, 4, 6)[i % 5] if i % 7 == 0 else 0
        lib.mock_add(k)
        want += k in step_graph._WORK_NODES
        if i % 13 == 0:
            assert count() == i + 1
            seen.append((i + 1, want))
    assert typed == []
    assert [count.work(c) for c, _ in seen] == [w for _, w in seen]
    assert count.work(count()) == want
    assert len(typed) == len(set(typed)) == 2500
    lib.mock_capture_ends()
    with pytest.raises(RuntimeError, match="not capturing"):
        step_graph._NodeCount()


def test_windows_finds_each_replay_of_a_trace():
    """log.windows over a trace of three steps (copies, a replay, a loss
    each) gives each replay's start; attribute on one replay's events
    finds it at 0."""
    step = ["Memcpy DtoD"] * 2 + REPLAY + ["pow", "reduce"]
    names = step * 3
    starts = log.windows(synthetic_map(), names)
    assert starts == [2, 14, 26]
    ev = events(names)
    got = log.attribute(synthetic_map(), ev[14:22])
    assert got["window"] == [0, 8]
