"""Leveled logging, stage timers, and the port's layer spans.

Reference: transit/src/transitstd.c:30-83 (tr_output level-gated printing)
and timestart/timecheck (transitstd.c:346-374) wall-clock stage
checkpoints; the counterpart of transit_tpu.utils.log.  A stage given a
``sync`` (a CUDA device, or a tensor on one) waits for that device's
queued work before it stops its clock, so device work is attributed to
the stage that launched it.

**Spans.**  ``with span("cia"): ...`` marks a layer of the step (the
names are PERF.md's layers).  What a span records depends on where it
runs:

- while a graph's layer map is recorded (:class:`MapRecorder`, which
  step_graph.GraphedStep activates while it captures a step): the
  device-work nodes (kernels, copies, fills) the graph holds at the
  span's entry and exit, so the span owns the nodes [first, last) it put
  into the graph, with its parent and depth (:class:`LayerMap`); the
  port's kernel wrappers add their launch's node and kernel name
  (:func:`launched`);
- eager, under an active ``torch.profiler``: a
  ``record_function("transit.<name>")``, host-side attribution;
- otherwise: a push and a pop of the name on a stack, nothing stored.

No span runs while a captured graph replays, so a span never adds a
device event to a replay's trace.

**Layer maps.**  :data:`MAPS` keeps every captured graph's map by (the
step's ``what``, its call signature, "fwd" or "bwd"), and :data:`SETUP`
the host seconds of each capture's warm-up calls, of the capture and of
the map's bookkeeping, as plain Python data: they outlive the model.
A backward graph (``torch.cuda.make_graphed_callables``) is captured as
autograd runs the backward; :class:`BackwardMap` opens ``<span>.bwd``
before each autograd node of the recorded forward runs, the span that
created the node (nested as the forward's spans are), and the custom
Functions' backwards open spans of their own.  :func:`attribute` lays a
map over a profiled replay's device events.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import functools
import logging
import sys
import time

import torch
from torch.autograd import profiler as _profiler

logger = logging.getLogger("transit_tpu_torch")

# Verbosity mapping of the reference's 1..5 levels (flags_tr.h:106-115):
_LEVELS = {1: logging.ERROR, 2: logging.WARNING, 3: logging.INFO,
           4: logging.INFO, 5: logging.DEBUG}


def set_verbosity(verb: int):
    """Map the reference's --verb 1..5 to logging levels."""
    if not logger.handlers:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter("%(levelname)s :: %(message)s"))
        logger.addHandler(h)
    logger.setLevel(_LEVELS.get(int(verb), logging.INFO))


def warn(msg: str, *args):
    """tr_output(TOUT_WARN, ...) analogue (transitstd.c:30-83)."""
    logger.warning(msg, *args)


def _synchronize(sync):
    device = sync.device if isinstance(sync, torch.Tensor) else \
        torch.device(sync)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Timers:
    """Stage wall-clock checkpoints (transitstd.c timestart/timecheck);
    each stage is a :func:`span` of its name."""

    def __init__(self):
        self.records = []
        self._t0 = time.perf_counter()

    @contextlib.contextmanager
    def stage(self, name: str, sync=None):
        t0 = time.perf_counter()
        with span(name):
            yield
            if sync is not None:
                _synchronize(sync)
        dt = time.perf_counter() - t0
        self.records.append((name, dt))
        logger.info("stage %-28s %8.3f s", name, dt)

    def report(self) -> str:
        total = time.perf_counter() - self._t0
        lines = [f"  {n:<30} {dt:8.3f} s" for n, dt in self.records]
        lines.append(f"  {'TOTAL':<30} {total:8.3f} s")
        return "\n".join(lines)


# ---------------------------------------------------------------------
# Spans

# The open spans, innermost last: a span's name when nothing records it,
# else its handle (a _Recorded or a _Profiled).
_stack: list = []
# The MapRecorder of the graph being captured, or None.
_recorder = None

# (what, signature, "fwd" | "bwd") -> LayerMap of a captured graph.
MAPS: dict = {}
# (what, signature) -> [(name, host seconds)] of a capture's set-up:
# "warmup" per warm-up call, "capture", and "layer_map" (the part of
# "capture" the layer maps' bookkeeping took).
SETUP: dict = {}

class _Span:
    """The context manager of :func:`span`: one object per name, which
    keeps nothing per use."""
    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        if _recorder is None and not _profiler._is_profiler_enabled:
            _stack.append(self.name)
        else:
            _stack.append(_open(self.name))

    def __exit__(self, *exc):
        top = _stack.pop()
        if top is not self.name:
            top.close()


_SPANS: dict = {}


def span(name: str) -> _Span:
    """``with span(name):`` marks a layer of the step (module docstring)."""
    s = _SPANS.get(name)
    if s is None:
        s = _SPANS[name] = _Span(name)
    return s


def launched(kernel: str):
    """A port kernel wrapper's note, right after its launch: while a map
    is recorded, the launch's node (the graph's last device-work node)
    and the kernel's device name."""
    if _recorder is not None:
        _recorder.launched(kernel)


class _Profiled:
    __slots__ = ("name", "rf")

    def __init__(self, name: str):
        self.name = name
        self.rf = _profiler.record_function("transit." + name)
        self.rf.__enter__()

    def close(self):
        self.rf.__exit__(None, None, None)


def _open(name: str):
    if _recorder is not None:
        return _recorder.enter(name)
    return _Profiled(name)


# ---------------------------------------------------------------------
# Layer maps

@dataclasses.dataclass
class LayerMap:
    """The layer map of one captured graph.  ``spans``: [(name, parent
    index or -1, depth, first, last)] in the order they opened, each
    span's device-work nodes [first, last) in the graph's order;
    ``kernels``: [(node, kernel name)] of the port's kernel launches;
    ``nodes``: the graph's device-work nodes (kernels, copies, fills),
    one device event each in a replay's trace."""
    spans: list
    kernels: list
    nodes: int


class _Recorded:
    __slots__ = ("name", "rec", "index")

    def __init__(self, name: str, rec, index: int):
        self.name, self.rec, self.index = name, rec, index

    def close(self):
        self.rec.exit(self.index)


class MapRecorder:
    """Records the layer map of the graph being captured while it is
    active (``with``), and stores it in :data:`MAPS` under ``key`` at
    the end.  ``count()`` gives the nodes the graph holds so far
    (step_graph reads them through libcuda; a test may count
    otherwise); when it has a ``work(c)``, that turns each count into
    the device-work nodes among the first ``c`` as the map closes, else
    the counts are of device work already.  ``tags``: keep, at each span edge, the autograd sequence
    number and the open spans' names, so that :class:`BackwardMap` can
    tell which span created a node.  ``seconds``: host time of the
    bookkeeping."""

    def __init__(self, key, count, tags: bool = False):
        self.key, self.count, self.tags = key, count, tags
        self.spans, self.kernels, self.open = [], [], []
        self.seq = []          # [(sequence number, open span names)]
        self.seconds = 0.0
        self.map = None

    def __enter__(self):
        global _recorder
        _recorder = self
        return self

    def __exit__(self, *exc):
        self.finish()

    def enter(self, name: str) -> _Recorded:
        t = time.perf_counter()
        i = len(self.spans)
        self.spans.append([name, self.open[-1] if self.open else -1,
                           len(self.open), self.count(), None])
        self.open.append(i)
        self._tag()
        self.seconds += time.perf_counter() - t
        return _Recorded(name, self, i)

    def exit(self, i: int):
        if self.map is not None:
            return
        t = time.perf_counter()
        self.spans[i][4] = self.count()
        self.open.remove(i)
        self._tag()
        self.seconds += time.perf_counter() - t

    def _tag(self):
        if self.tags:
            # the sequence number the next autograd node gets
            self.seq.append((torch._C._autograd._get_sequence_nr(),
                             tuple(self.spans[j][0] for j in self.open)))

    def launched(self, kernel: str):
        t = time.perf_counter()
        self.kernels.append((self.count(), kernel))
        self.seconds += time.perf_counter() - t

    def finish(self) -> LayerMap:
        """Close the map (spans still open end at the graph's last node)
        and store it; the recorder stops recording."""
        global _recorder
        if _recorder is self:
            _recorder = None
        if self.map is None:
            t = time.perf_counter()
            nodes = self.count()
            for i in self.open:
                self.spans[i][4] = nodes
            self.open = []
            work = getattr(self.count, "work", lambda c: c)
            self.map = MAPS[self.key] = LayerMap(
                [(n, up, d, work(a), work(b)) for n, up, d, a, b in
                 self.spans],
                [(work(c) - 1, k) for c, k in self.kernels], work(nodes))
            self.seconds += time.perf_counter() - t
        return self.map


class BackwardMap:
    """The layer map of the backward of a forward that ``fwd`` recorded
    with ``tags``, captured as autograd runs it: a prehook on every
    autograd node that ``outputs`` reach opens ``<span>.bwd`` for the
    spans open when the node was created (those of the node before it
    close), and the map is stored under ``key`` once every tensor of
    ``inputs`` that requires grad has received its gradient.  Its
    recorder (``count()``, made by ``counter()`` as the backward starts)
    becomes active at the first node.  :meth:`close` removes the hooks;
    a map its hooks did not finish is not stored."""

    def __init__(self, fwd: MapRecorder, outputs, inputs, key, counter):
        t = time.perf_counter()
        self.key, self.counter = key, counter
        self.at = [s for s, _ in fwd.seq]
        self.names = [p for _, p in fwd.seq]
        self.rec, self.path, self.opened = None, (), []
        self.handles, seen = [], set()
        todo = [o.grad_fn for o in outputs if o.grad_fn is not None]
        while todo:
            node = todo.pop()
            if node is None or node in seen:
                continue
            seen.add(node)
            todo.extend(n for n, _ in node.next_functions)
            if type(node).__name__ == "AccumulateGrad":
                continue
            path = self._created_in(node._sequence_nr())
            self.handles.append(node.register_prehook(
                functools.partial(self._pre, path)))
            if isinstance(node, torch.autograd.function.BackwardCFunction):
                # A custom Function's backward opens spans of its own; the
                # sums autograd adds its gradients into go to a leaf.
                self.handles.append(node.register_hook(
                    functools.partial(self._post, path)))
        self.pending = 0
        for x in inputs:
            if x.requires_grad:
                self.pending += 1
                self.handles.append(x.register_hook(self._input_done))
        self.seconds = time.perf_counter() - t

    def _created_in(self, seq: int) -> tuple:
        i = bisect.bisect_right(self.at, seq) - 1
        return self.names[i] if i >= 0 else ()

    def _switch(self, path: tuple):
        k = 0
        while (k < min(len(path), len(self.path)) and
               path[k] == self.path[k]):
            k += 1
        while len(self.opened) > k:
            h = self.opened.pop()
            _stack.remove(h)
            h.close()
        for name in path[k:]:
            h = self.rec.enter(name)
            _stack.append(h)
            self.opened.append(h)
        self.path = path

    def _pre(self, created_in, grad_outputs):
        global _recorder
        if self.rec is None:
            self.rec = MapRecorder(self.key, self.counter())
            _recorder = self.rec
        if self.rec.map is None:
            self._switch(tuple(n + ".bwd" for n in created_in))

    def _post(self, created_in, grad_inputs, grad_outputs):
        if self.rec.map is None:
            self._switch(tuple(n + ".bwd" for n in created_in) +
                         ("grad_sum",))

    def _input_done(self, grad):
        self.pending -= 1
        if self.pending == 0 and self.rec is not None and \
                self.rec.map is None:
            self._switch(())
            self.rec.finish()

    def close(self):
        """Remove the hooks; a map not finished inside the capture is
        dropped with a warning."""
        for h in self.handles:
            h.remove()
        self.handles = []
        if self.rec is not None and self.rec.map is None:
            for h in self.opened:
                _stack.remove(h)
            self.opened = []
            global _recorder
            if _recorder is self.rec:
                _recorder = None
            warn("%s: the backward's layer map did not end inside its "
                 "capture; it is not kept", self.key)

    @property
    def bookkeeping(self) -> float:
        return self.seconds + (self.rec.seconds if self.rec else 0.0)


# ---------------------------------------------------------------------
# Attribution of a replay

def is_kernel(name: str) -> bool:
    """A device event that is a kernel, not a copy or a fill."""
    return not name.startswith(("Memcpy", "Memset"))


def device_events(prof) -> list:
    """The device events [(name, start s, end s)] of a finished
    ``torch.profiler.profile``, in start order: kernels, copies and
    fills (user annotations left out)."""
    from torch.autograd import DeviceType

    ev = [(e.name, e.time_range.start * 1e-6, e.time_range.end * 1e-6)
          for e in prof.events() if e.device_type == DeviceType.CUDA and
          not getattr(e, "is_user_annotation", False) and
          not e.name.startswith(("transit.", "bench."))]
    return sorted(ev, key=lambda e: e[1])


def windows(m: LayerMap, names: list) -> list:
    """The starts of the windows of ``m.nodes`` consecutive events (of
    names ``names``, in start order) whose port kernels sit at the map's
    recorded positions, and no port kernel elsewhere: the replays of its
    graph in a trace."""
    n = m.nodes
    if not m.kernels:
        return []
    at = dict(m.kernels)
    kinds = set(at.values())
    p0, k0 = m.kernels[0]
    found = []
    for j, name in enumerate(names):
        i = j - p0
        if k0 not in name or i < 0 or i + n > len(names):
            continue
        if all(k in names[i + p] for p, k in m.kernels) and not any(
                p not in at and any(k in names[i + p] for k in kinds)
                for p in range(n)):
            found.append(i)
    return found


def attribute(m: LayerMap, events: list, key=None):
    """Lay a graph's layer map over one traced step's device events
    ([(name, start, end)] in start order, seconds: :func:`device_events`
    of a profile of one step, or one step's part of a longer one).

    The replay is the one window of ``m.nodes`` consecutive events whose
    port kernels sit exactly at the map's positions; the step's other
    events (input copies, the output's clone, a loss) lie outside it.
    With no such window, or more than one, it returns None and warns why;
    it never guesses.  Otherwise {"spans": {path: {"ms", "self_ms",
    "kernels", "intervals"}}, "unattributed_ms", "ms", "port_ms",
    "window"}: per span path (a tuple of names from the outermost span),
    summed over its instances, the device ms of its events (durations
    summed, as per-kernel sums are), those no child span holds, its
    kernels (copies and fills not counted) and each instance's
    [start, end] on the trace's clock (from its first event's start to
    its last one's end, so an idle gap inside the step lies between two
    layers' intervals); the window's ms under no span, its ms in all, its
    port kernels' ms, and [first, end) of the window in ``events``.

    An operator profiling a retrieval does as the benchmark does:
    profile steps of ``fwd = model.make_forward()``, find each graph's
    replays in the trace (:func:`windows` of ``MAPS[key]`` over
    :func:`device_events` of the profile, one a step and key; a gradient
    step replays a "fwd" and a "bwd" graph), and attribute each replay's
    events: ``attribute(MAPS[key], events[i:i + MAPS[key].nodes])``."""
    found = windows(m, [e[0] for e in events])
    if len(found) != 1:
        warn("attribute %s: %d windows of %d events hold the map's %d port "
             "kernels at their positions", key or "", len(found), m.nodes,
             len(m.kernels))
        return None
    i0 = found[0]
    ev = events[i0:i0 + m.nodes]
    owner = [-1] * m.nodes
    for idx in sorted(range(len(m.spans)), key=lambda i: m.spans[i][2]):
        _, _, _, a, b = m.spans[idx]
        owner[a:b] = [idx] * (b - a)
    paths = []
    for name, parent, _, _, _ in m.spans:
        paths.append((paths[parent] if parent >= 0 else ()) + (name,))
    spans = {p: {"ms": 0.0, "self_ms": 0.0, "kernels": 0, "intervals": []}
             for p in paths}
    for idx, (_, _, _, a, b) in enumerate(m.spans):
        if b > a:
            spans[paths[idx]]["intervals"].append([ev[a][1], ev[b - 1][2]])
    free = 0.0
    for (name, t0, t1), idx in zip(ev, owner):
        ms = (t1 - t0) * 1e3
        if idx < 0:
            free += ms
            continue
        p = paths[idx]
        spans[p]["self_ms"] += ms
        for k in range(1, len(p) + 1):
            spans[p[:k]]["ms"] += ms
            spans[p[:k]]["kernels"] += is_kernel(name)
    kinds = {k for _, k in m.kernels}
    return {"spans": spans, "unattributed_ms": free,
            "ms": sum((t1 - t0) * 1e3 for _, t0, t1 in ev),
            "port_ms": sum((t1 - t0) * 1e3 for n, t0, t1 in ev
                           if any(k in n for k in kinds)),
            "window": [i0, i0 + m.nodes]}
