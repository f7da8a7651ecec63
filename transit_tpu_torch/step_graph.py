"""The retrieval step captured as CUDA graphs: the callable that
``TransitModel.make_forward`` returns on a card, the counterpart of
transit_tpu's ``jax.jit(lambda dev, t, q: self.forward(t, q, dev=dev))``
(transit_tpu/model.py:374-379).

Each distinct call signature (the shapes and dtypes of T and q, and
which of them a gradient is asked of) is captured once, after warm-up
calls on a side stream that build the kernels and make every constant
tensor the step reads (the model's caches of host tables).  A call
without gradient replays a forward-only ``torch.cuda.CUDAGraph``; a call
under grad mode with an input that requires grad replays the forward of
``torch.cuda.make_graphed_callables``, whose autograd node replays the
captured backward.  A 2-D T (B, nl) with q (B, nmol, nl) runs
``forward_batch`` (fast mode with the file's radii; else
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
    """Identity on (T, q) whose backward copies the gradients: the
    captured backward returns its static buffers, which the next replay
    overwrites.  It also refuses the gradient of a call that a later
    call of the same graph has replaced (``entry.calls`` moved on)."""

    @staticmethod
    def forward(ctx, entry, T, q):
        ctx.entry, ctx.call = entry, entry.calls
        return T.view_as(T), q.view_as(q)

    @staticmethod
    def backward(ctx, gT, gq):
        if ctx.entry.calls != ctx.call:
            raise RuntimeError(
                "make_forward: the gradient of a call was taken after a "
                "later call of the same signature replayed the captured "
                "forward; take each call's gradient before the next call")
        return (None, *(g.clone() if need and g is not None else None
                        for g, need in zip((gT, gq),
                                           ctx.needs_input_grad[1:])))


class _Entry:
    """One captured signature: ``run(T, q)`` replays it; ``calls``
    counts the calls."""
    calls = 0


class _GradEntry(_Entry):
    """A signature with a gradient: ``graphed`` is the callable of
    torch.cuda.make_graphed_callables."""

    def __init__(self, graphed):
        self.graphed = graphed

    def run(self, T, q):
        return self.graphed(*_OwnGrads.apply(self, T, q)).clone()


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


class GraphedForward:
    """``(T, q) -> spectrum`` of ``model`` as CUDA graph replays (see the
    module's docstring).  The settings the step reads as Python values
    are the model's when the object is made (``model._settings()``), and
    the line tensors are ``model.device_tree()``."""

    def __init__(self, model):
        if model.device.type != "cuda":
            raise ValueError("GraphedForward captures a model on a card")
        self.model = model
        self.settings = model._settings()
        self.dev = model.device_tree()
        self.entries = {}

    def step(self, T, q):
        """The eager step with the fixed settings and the bound tensors
        (``TransitModel._step``)."""
        return self.model._step(T, q, self.settings, self.dev)

    def __call__(self, T, q):
        m = self.model
        T = torch.as_tensor(T, dtype=m.dtype, device=m.device)
        q = torch.as_tensor(q, dtype=m.dtype, device=m.device)
        grad = torch.is_grad_enabled()
        key = (tuple(T.shape), tuple(q.shape), T.dtype, q.dtype,
               grad and T.requires_grad, grad and q.requires_grad)
        entry = self.entries.get(key)
        if entry is None:
            try:
                with _no_collection():
                    entry = (self._capture_grad(T, q, key) if any(key[4:])
                             else self._capture_forward(T, q))
            except Exception as e:
                raise RuntimeError(
                    f"make_forward: capturing the step for T {key[0]}, q "
                    f"{key[1]} (grad T, q: {key[4]}, {key[5]}) failed at "
                    f"{_where(e)}") from e
            self.entries[key] = entry
        entry.calls += 1
        return entry.run(T, q)

    def _capture_forward(self, T, q) -> _Entry:
        sT, sq = T.detach().clone(), q.detach().clone()
        g = torch.cuda.CUDAGraph()
        with torch.no_grad():
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                for _ in range(WARMUP):
                    self.step(sT, sq)
            torch.cuda.current_stream().wait_stream(side)
            with torch.cuda.graph(g):
                out = self.step(sT, sq)
        entry = _Entry()

        def run(T, q):
            sT.copy_(T)
            sq.copy_(q)
            g.replay()
            return out.clone()
        entry.run, entry.graph = run, g
        return entry

    def _capture_grad(self, T, q, key) -> _Entry:
        sT = T.detach().clone().requires_grad_(key[4])
        sq = q.detach().clone().requires_grad_(key[5])
        return _GradEntry(torch.cuda.make_graphed_callables(
            self.step, (sT, sq), num_warmup_iters=WARMUP))
