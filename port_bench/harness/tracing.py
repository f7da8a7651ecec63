"""The traced slice of a run: torch.profiler over a fixed run of steps of
the window, reduced to device intervals and the harness's host spans.

Device time is the union of the device intervals (kernels, copies,
fills), so that work on two streams is not counted twice.  The harness
labels its own host work with ``bench.*`` record_function spans, and an
idle gap of the device is named by the innermost such span and the
innermost other host operation that cover its middle."""

from __future__ import annotations

import dataclasses

# The port's own CUDA kernels (transit_tpu_torch/csrc/*.cu), by the name
# the device trace gives them.
PORT_KERNELS = ("line_tile_kernel", "layer_kmax_kernel", "shell_tile_kernel",
                "line_tile_bwd_kernel", "shell_tile_bwd_kernel",
                "profile_scatter_kernel", "profile_scatter_bwd_kernel")


@dataclasses.dataclass
class Slice:
    """Device events [(name, start s, end s)], host spans of the
    harness [(name, start s, end s)], other host operations, the
    slice's bounds and its step count."""
    device: list
    spans: list
    host: list
    t0: float
    t1: float
    steps: int

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


def from_profiler(prof, steps: int) -> Slice:
    """The slice of a finished torch.profiler.profile: its bounds are the
    first and last ``bench.step`` spans."""
    from torch.autograd import DeviceType

    dev, spans, host = [], [], []
    for e in prof.events():
        t = (e.name, e.time_range.start * 1e-6, e.time_range.end * 1e-6)
        if e.name.startswith("bench."):
            # A record_function span; on the device timeline its copy
            # (a user annotation) covers the gaps too, and is left out.
            if e.device_type != DeviceType.CUDA:
                spans.append(t)
        elif e.device_type == DeviceType.CUDA:
            dev.append(t)
        else:
            host.append(t)
    steps_at = [s for s in spans if s[0] == "bench.step"]
    t0 = min(s[1] for s in steps_at)
    t1 = max(s[2] for s in steps_at)
    dev = [(n, max(a, t0), min(b, t1)) for n, a, b in dev
           if b > t0 and a < t1]
    return Slice(sorted(dev, key=lambda d: d[1]), spans, host, t0, t1, steps)


def union(intervals) -> list:
    """Merged [(start, end)] of intervals sorted by start."""
    out = []
    for _, a, b in intervals:
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def busy_seconds(sl: Slice) -> float:
    return sum(b - a for a, b in union(sl.device))


def is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset"))


def is_port(name: str) -> bool:
    return any(k in name for k in PORT_KERNELS)


def device_seconds(sl: Slice, pred) -> float:
    """Summed device seconds of the events whose name passes ``pred``."""
    return sum(b - a for n, a, b in sl.device if pred(n))


# Idle gaps shorter than this are summed as one entry, not named.
SHORT_GAP = 20e-6


def _innermost(items, t):
    best = None
    for n, a, b in items:
        if a <= t <= b and (best is None or b - a < best[2] - best[1]):
            best = (n, a, b)
    return best[0] if best else ""


def breakdown(sl: Slice, top: int = 10) -> dict:
    """The ten device operations that took most time and the ten host
    activities under which the device idled longest, each [name, s]."""
    by_name = {}
    for n, a, b in sl.device:
        by_name[n[:160]] = by_name.get(n[:160], 0.0) + (b - a)
    ops = sorted(by_name.items(), key=lambda x: -x[1])[:top]
    edges = [sl.t0] + [x for iv in union(sl.device) for x in iv] + [sl.t1]
    gaps = {}
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        if b - a < SHORT_GAP:
            name = f"gaps under {SHORT_GAP * 1e6:g} us (between launches)"
        else:
            m = 0.5 * (a + b)
            span = _innermost(sl.spans, m)
            name = (f"{span}: {_innermost(sl.host, m)}" if span else
                    "between steps (the harness's loop)")
        gaps[name[:160]] = gaps.get(name[:160], 0.0) + (b - a)
    idle = sorted(gaps.items(), key=lambda x: -x[1])[:top]
    return {"device_ops": [list(x) for x in ops],
            "idle_gaps": [list(x) for x in idle]}
