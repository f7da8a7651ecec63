"""Whether the window's outputs are correct: each kept step's spectra
(and, for a gradient step, d chi2/dT and d chi2/dq) against the plain
reference (port_bench/reference), profile by profile.

The profiles checked: ``check_members`` of each kept step's, drawn
from the seed.  The numbers, each the largest over them: ``spectrum``,
||flux - ref|| / ||ref||; ``grad_T`` and ``grad_q``, the same of the two
gradients; ``<name>_median``, the median over the elements of
|a - ref| / |ref|; and ``<name>_p95``, the 95th percentile over the
elements of |a - ref| / (|ref| + EPS max|ref|), which a fault in a
twentieth of the elements moves (one chunk of exact mode's layers, one
band of fast mode's, one molecule's abundances).  A cell compares those
that have a limit in ``port_bench/limits/<cell>.json``."""

from __future__ import annotations

import numpy as np
import torch


def rel(a, ref) -> float:
    """||a - ref|| / ||ref||, infinite where a is not finite."""
    a, ref = a.double().reshape(-1), ref.double().reshape(-1)
    if not bool(torch.isfinite(a).all()):
        return float("inf")
    return float((a - ref).norm() / ref.norm())


def ratios(gap, den):
    """gap / den elementwise, 0 where both are 0 (an element that is 0 on
    both sides agrees) and infinite where only den is."""
    out = gap / den
    return torch.where((gap == 0) & (den == 0), torch.zeros_like(out), out)


def rel_median(a, ref) -> float:
    """The median over elements of |a - ref| / |ref|, infinite where a is
    not finite: steady where one element's rounding flips a discrete
    choice (a profile's table index) that moves ``rel`` alone."""
    a, ref = a.double().reshape(-1), ref.double().reshape(-1)
    if not bool(torch.isfinite(a).all()):
        return float("inf")
    return float(ratios((a - ref).abs(), ref.abs()).median())


# The share of the largest |ref| added to each element's |ref| in the
# ``_p95`` numbers, so that elements that cancel to near zero in the
# reference do not read as large relative gaps.
EPS = 1e-3


def rel_p95(a, ref) -> float:
    """The 95th percentile over elements of |a - ref| / (|ref| + EPS
    max|ref|), infinite where a is not finite."""
    a, ref = a.double().reshape(-1), ref.double().reshape(-1)
    if not bool(torch.isfinite(a).all()):
        return float("inf")
    r = ref.abs()
    gap = ratios((a - ref).abs(), r + EPS * r.max())
    return float(np.percentile(gap.cpu().numpy(), 95))


def members(loop, step: int, n: int, seed: int) -> list:
    """(position in the batch, pool row) of ``n`` of the step's profiles,
    drawn from the seed and the step."""
    rng = np.random.default_rng([int(seed) % (1 << 63), step])
    pick = sorted(rng.choice(loop.B, min(n, loop.B), replace=False).tolist())
    rows = loop.members(step)
    return [(b, rows[b]) for b in pick]


def readings(ref, loop, kept: dict, n: int, seed: int,
             outputs=None) -> dict:
    """The numbers of ``n`` profiles of each kept step (step -> outputs,
    on the device of the run) against ``ref`` (a
    reference.model.Reference); ``outputs``: another model in the
    program's place (the control), a function of (T, q) -> outputs of
    one profile."""
    names = ("spectrum", "grad_T", "grad_q") if loop.grad else ("spectrum",)
    out = {f"{a}{b}": 0.0 for a in names for b in SUFFIXES}
    for i in sorted(kept):
        got = kept[i]
        for b, k in members(loop, i, n, seed):
            T = loop.T[k].detach().double()
            q = loop.q[k].detach().double()
            if outputs is not None:
                one = outputs(T, q)
            else:
                one = [g if loop.B == 1 else g[b] for g in got]
            if loop.grad:
                want = ref.chi2_grad(T, q, loop.obs.double(),
                                     loop.sigma.double())
            else:
                want = (ref.spectrum(T, q),)
            for name, a, b in zip(names, one, want):
                for suffix, fn in (("", rel), ("_median", rel_median),
                                   ("_p95", rel_p95)):
                    v = fn(a, b)
                    # A number that is not a number fails.
                    out[name + suffix] = max(out[name + suffix],
                                             float("inf") if v != v else v)
    return out


def control_outputs(ctrl, loop):
    """The control in the program's place: the reference ``ctrl`` in the
    precision below the configuration's (reference.model.Reference in
    float32 with TF32 products, or in bfloat16)."""
    dt = ctrl.dtype

    def outputs(T, q):
        if loop.grad:
            return ctrl.chi2_grad(T.to(dt), q.to(dt), loop.obs.to(dt),
                                  loop.sigma.to(dt))
        return (ctrl.spectrum(T.to(dt), q.to(dt)),)
    return outputs


def control_reference(problem, device, kind: str):
    """The control's reference: ``tf32`` (float32, TF32 products) or
    ``bfloat16``."""
    from port_bench.reference.model import Reference
    if kind == "tf32":
        return Reference(problem, device, torch.float32, allow_tf32=True)
    return Reference(problem, device, getattr(torch, kind))


def verdict(numbers: dict, limits: dict) -> bool:
    """Every number that has a limit is within it."""
    return all(numbers[k] <= v for k, v in limits.items())


def compared(limits: dict) -> dict:
    """The limits of the numbers (the limits file's other keys describe
    the control)."""
    return {k: v for k, v in limits.items() if k in NUMBERS}


SUFFIXES = ("", "_median", "_p95")
NUMBERS = tuple(f"{n}{s}" for n in ("spectrum", "grad_T", "grad_q")
                for s in SUFFIXES)
