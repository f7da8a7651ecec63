"""Steps captured as CUDA graphs (:class:`GraphedStep`), the port's
counterpart of ``jax.jit``: on a card, the callable that
``TransitModel.make_forward`` returns (transit_tpu/model.py:374-379,
``jax.jit(lambda dev, t, q: self.forward(t, q, dev=dev))``), the
sharded step of ``parallel.sharded.make_sharded_forward`` (JAX's jitted
``step_impl`` around its shard_map, transit_tpu/parallel/sharded.py:
340-355) and the band step and band kmax of
``parallel.multihost.MultihostForward`` (transit_tpu/parallel/
multihost.py:207-216).

Each distinct call signature (the shapes and dtypes of the step's tensor
arguments, and which of them a gradient is asked of) is captured once,
after warm-up calls on a side stream that build the kernels and make
every constant tensor the step reads (the model's caches of host
tables).  A call without gradient replays a forward-only
``torch.cuda.CUDAGraph``; a call under grad mode with an input that
requires grad replays the forward of
``torch.cuda.make_graphed_callables``, whose autograd node replays the
captured backward.  In ``make_forward`` a 2-D T (B, nl) with q (B,
nmol, nl) runs ``forward_batch`` (fast mode with the file's radii; else
``torch.func.vmap`` of ``forward``), graphed per B.

JAX's value semantics: every call returns a tensor of its own, and the
gradients that reach the inputs are copies, not the graphs' static
buffers, which the next replay overwrites.  A call's gradient must be
taken before the next call of the same signature replays the forward:
the graph holds one set of saved activations, and a later backward
raises.  A capture that fails raises, naming the step's line that
failed; nothing falls back to eager calls.
"""

from __future__ import annotations

import contextlib
import gc
import os
import traceback

import torch

# Eager calls of the step on a side stream before a capture: the first
# builds and loads the kernels and fills the model's caches, the second
# runs as every later call does.
WARMUP = 2

_PACKAGE = os.path.dirname(os.path.abspath(__file__))


class _OwnGrads(torch.autograd.Function):
    """Identity on a step's tensor arguments whose backward copies the
    gradients: the captured backward returns its static buffers, which
    the next replay overwrites.  It also refuses the gradient of a call
    that a later call of the same graph has replaced (``entry.calls``
    moved on)."""

    @staticmethod
    def forward(ctx, entry, *args):
        ctx.entry, ctx.call = entry, entry.calls
        return tuple(a.view_as(a) for a in args)

    @staticmethod
    def backward(ctx, *grads):
        if ctx.entry.calls != ctx.call:
            raise RuntimeError(
                f"{ctx.entry.what}: the gradient of a call was taken after "
                "a later call of the same signature replayed the captured "
                "forward; take each call's gradient before the next call")
        return (None, *(g.clone() if need and g is not None else None
                        for g, need in zip(grads, ctx.needs_input_grad[1:])))


class _Entry:
    """One captured signature: ``run(*args)`` replays it; ``calls``
    counts the calls; ``what`` names the step in messages."""
    calls = 0

    def __init__(self, what: str):
        self.what = what


class _GradEntry(_Entry):
    """A signature with a gradient: ``graphed`` is the callable of
    torch.cuda.make_graphed_callables."""

    def __init__(self, what: str, graphed):
        super().__init__(what)
        self.graphed = graphed

    def run(self, *args):
        return self.graphed(*_OwnGrads.apply(self, *args)).clone()


@contextlib.contextmanager
def _no_collection():
    """Collect garbage before a capture and not during it: cyclic garbage
    (make_graphed_callables' autograd Function of an earlier callable)
    can hold CUDA graphs, and destroying a graph while a stream captures
    invalidates the capture."""
    gc.collect()
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


def _where(exc: BaseException) -> str:
    """The innermost line of this package in the tracebacks of ``exc``
    and of the exceptions it was raised during (a failed capture raises
    again when the capture ends), with that exception's message."""
    chain, e = [], exc
    while e is not None and len(chain) < 8:
        chain.append(e)
        e = e.__cause__ or e.__context__
    for e in reversed(chain):
        frames = [f for f in traceback.extract_tb(e.__traceback__)
                  if f.filename.startswith(_PACKAGE)]
        if frames:
            f = frames[-1]
            rel = os.path.relpath(f.filename, os.path.dirname(_PACKAGE))
            return (f"{rel}:{f.lineno} ({f.line}): {type(e).__name__}: "
                    f"{str(e).splitlines()[0] if str(e) else ''}")
    return f"{type(exc).__name__}: {exc}"


class GraphedStep:
    """A step ``fn(*args) -> tensor`` of tensor arguments as CUDA graph
    replays (see the module's docstring).  Every argument is taken as a
    tensor of ``dtype`` on ``device`` (the card); ``what`` names the step
    in messages and ``names`` its arguments.  Each signature (the
    arguments' shapes and dtypes, and under grad mode which of them
    require grad) is captured once; an argument that needs no gradient
    (an external kmax) is copied into the graph's static buffer as the
    others are.  ``entries`` holds the captured signatures."""

    def __init__(self, fn, dtype, device, what: str, names=("T", "q")):
        device = torch.device(device)
        if device.type != "cuda":
            raise ValueError(f"{what}: a CUDA graph captures a step on a "
                             f"card, not on {device}")
        self.fn, self.dtype, self.device = fn, dtype, device
        self.what, self.names = what, tuple(names)
        self.entries = {}

    def __call__(self, *args):
        args = tuple(torch.as_tensor(a, dtype=self.dtype, device=self.device)
                     for a in args)
        grad = torch.is_grad_enabled()
        key = tuple((tuple(a.shape), a.dtype, grad and a.requires_grad)
                    for a in args)
        entry = self.entries.get(key)
        if entry is None:
            try:
                with _no_collection():
                    entry = (self._capture_grad(args, key)
                             if any(k[2] for k in key)
                             else self._capture_forward(args))
            except Exception as e:
                names = self.names[:len(key)]
                shapes = ", ".join(f"{n} {k[0]}" for n, k in zip(names, key))
                grads = ", ".join(str(k[2]) for k in key)
                raise RuntimeError(
                    f"{self.what}: capturing the step for {shapes} (grad "
                    f"{', '.join(names)}: {grads}) failed at "
                    f"{_where(e)}") from e
            self.entries[key] = entry
        entry.calls += 1
        return entry.run(*args)

    def _capture_forward(self, args) -> _Entry:
        static = tuple(a.detach().clone() for a in args)
        g = torch.cuda.CUDAGraph()
        with torch.no_grad():
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                for _ in range(WARMUP):
                    self.fn(*static)
            torch.cuda.current_stream().wait_stream(side)
            with torch.cuda.graph(g):
                out = self.fn(*static)
        entry = _Entry(self.what)

        def run(*args):
            for s, a in zip(static, args):
                s.copy_(a)
            g.replay()
            return out.clone()
        entry.run, entry.graph = run, g
        return entry

    def _capture_grad(self, args, key) -> _Entry:
        static = tuple(a.detach().clone().requires_grad_(k[2])
                       for a, k in zip(args, key))
        return _GradEntry(self.what, torch.cuda.make_graphed_callables(
            self.fn, static, num_warmup_iters=WARMUP))
