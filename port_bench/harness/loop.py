"""The closed loop of one caller, and the measured window.

A step takes the next ``batch`` profiles of the pool (consecutive rows,
cycling; a batch of one is a single profile), runs the compiled step,
forms chi2 = sum(((flux - obs) / sigma)^2) and reads it to the host, the
sampler's accept test.  A gradient step asks autograd for d chi2/dT and
d chi2/dq through the compiled step; they stay on the device."""

from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np
import torch


class Loop:
    def __init__(self, fwd, pool, obs, sigma, traffic: dict):
        self.fwd = fwd
        self.T, self.q = pool
        self.obs, self.sigma = obs, sigma
        self.B = traffic["batch"]
        self.P = self.T.shape[0]
        if self.P % self.B:
            raise ValueError("the pool must hold whole batches")
        self.grad = traffic["step"] == "gradient"
        self.label = contextlib.nullcontext

    def members(self, i: int) -> list:
        a = (i * self.B) % self.P
        return list(range(a, a + self.B))

    def inputs(self, i: int):
        a = (i * self.B) % self.P
        if self.B == 1:
            return self.T[a], self.q[a]
        return self.T[a:a + self.B], self.q[a:a + self.B]

    def step(self, i: int):
        """(chi2 on the host, the step's outputs: (flux,) or (flux, dT,
        dq))."""
        with self.label("bench.inputs"):
            T, q = self.inputs(i)
        if not self.grad:
            with torch.no_grad():
                with self.label("bench.compiled_step"):
                    flux = self.fwd(T, q)
                with self.label("bench.chi2"):
                    chi2 = (((flux - self.obs) / self.sigma) ** 2).sum()
                with self.label("bench.read"):
                    return chi2.item(), (flux,)
        T = T.detach().requires_grad_()
        q = q.detach().requires_grad_()
        with self.label("bench.compiled_step"):
            flux = self.fwd(T, q)
        with self.label("bench.chi2"):
            chi2 = (((flux - self.obs) / self.sigma) ** 2).sum()
        with self.label("bench.backward"):
            dT, dq = torch.autograd.grad(chi2, (T, q))
        with self.label("bench.read"):
            return chi2.item(), (flux.detach(), dT, dq)


@dataclasses.dataclass
class Window:
    steps: int
    seconds: float
    step_s: list
    kept: dict          # step -> its outputs, for the check
    trace: object       # tracing.Slice, or None
    failed: int         # steps whose chi2 came back NaN or infinite


def check_steps(traffic: dict, seed: int) -> set:
    """The steps whose outputs the check compares besides the window's
    last (unless ``check_last`` is false): ``check_steps`` of the first
    ``check_span``, drawn from the seed."""
    rng = np.random.default_rng(int(seed) % (1 << 63))
    return set(rng.choice(traffic["check_span"], traffic["check_steps"],
                          replace=False).tolist())


def run(loop: Loop, seconds: float, traffic: dict, seed: int,
        trace: bool, sync) -> Window:
    """Steps until ``seconds`` have passed (and, with ``trace``, the
    traced slice has ended); the window runs from the first step's start
    to the last step's end.  The slice: steps trace_start to trace_start
    + trace_steps - 1 under torch.profiler, the harness's work labelled
    with bench.* spans."""
    from port_bench.harness import tracing

    keep = check_steps(traffic, seed)
    a = traffic["trace_start"]
    b = a + traffic["trace_steps"]
    times, kept, prof, done, failed = [], {}, None, None, 0
    i, paused = 0, 0.0
    t_start = time.perf_counter()
    while True:
        if trace and i == a:
            t = time.perf_counter()
            sync()
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            prof.__enter__()
            loop.label = torch.profiler.record_function
            paused += time.perf_counter() - t
        t = time.perf_counter()
        with loop.label("bench.step"):
            chi2, out = loop.step(i)
        t_end = time.perf_counter()
        times.append(t_end - t)
        failed += not np.isfinite(chi2)
        if i in keep:
            kept[i] = out
        if prof is not None and i == b - 1:
            # Stopping the profiler takes seconds; the window does not
            # count them (a traced run reports no end-to-end metric).
            sync()
            loop.label = contextlib.nullcontext
            prof.__exit__(None, None, None)
            done, prof = prof, None
            paused += time.perf_counter() - t_end
        i += 1
        if (t_end - t_start - paused >= seconds and
                (not trace or done is not None)):
            break
    if traffic.get("check_last", True) or not kept:
        # The last step stands in when no drawn step came due.
        kept[i - 1] = out
    sl = None if done is None else tracing.from_profiler(done, b - a)
    return Window(steps=i, seconds=t_end - t_start, step_s=times, kept=kept,
                  trace=sl, failed=failed)
