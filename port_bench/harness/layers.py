"""The program's layer maps laid over the traced slice: the device ms of
each of the program's spans a step (transit_tpu_torch/utils/log.py).

When the harness captures the cell's step (``loop.step(0)``), the
program records a layer map of each CUDA graph it captures: which of
the graph's device-work nodes each span of the program put there, and
where its own kernels sit (``log.MAPS``).  A replay runs no program
code, so the traced slice holds only the replays' device events:
``log.windows`` finds each graph's replays in it by its kernels'
positions (on the device's own clock, so no host span decides which
step an event belongs to), one a traced step, and ``log.attribute``
sums each span's events of each replay.  A program without layer maps
(one older than them), or a map whose replays in the trace are not one
a step, gives None: no metric reads a guess."""

from __future__ import annotations

import sys

from port_bench.harness import tracing


def _maps():
    try:
        from transit_tpu_torch.utils import log
    except ImportError:
        return None, None
    if not hasattr(log, "attribute"):
        return None, None
    return log, {k: m for k, m in log.MAPS.items()
                 if k[0] == "make_forward"}


def table(ctx):
    """{"fwd" | "bwd": {path: {"ms", "self_ms", "kernels"}}, "replay_ms",
    "unspanned_ms", ...} a step, computed once a run (ctx.cache) and then
    printed to standard error as the span table; None without maps or
    when a step's replay is not found."""
    if "layers" not in ctx.cache:
        ctx.cache["layers"] = _table(ctx)
        if ctx.cache["layers"] is not None:
            _print(ctx.cache["layers"])
            _print_setup()
    return ctx.cache["layers"]


def _table(ctx):
    log, maps = _maps()
    if not maps:
        return None
    ev, n = ctx.slice.device, ctx.slice.steps
    names = [e[0] for e in ev]
    out = {"fwd": {}, "bwd": {}, "replay_ms": {"fwd": 0.0, "bwd": 0.0},
           "port_ms": 0.0, "unspanned_ms": {"fwd": 0.0, "bwd": 0.0},
           "outside_non_port_ms": 0.0, "steps": n}
    inside = set()
    for key, m in maps.items():
        kind = key[2]
        starts = log.windows(m, names)
        if len(starts) != n:
            sys.stderr.write(f"layer map {key}: {len(starts)} replays in "
                             f"the trace of {n} steps\n")
            return None
        for i in starts:
            a = log.attribute(m, ev[i:i + m.nodes], key)
            if a is None or inside & set(range(i, i + m.nodes)):
                return None
            inside.update(range(i, i + m.nodes))
            out["replay_ms"][kind] += a["ms"] / n
            out["port_ms"] += a["port_ms"] / n
            free = a["unattributed_ms"]
            for path, v in a["spans"].items():
                row = out[kind].setdefault(path, {"ms": 0.0, "self_ms": 0.0,
                                                  "kernels": 0.0})
                row["ms"] += v["ms"] / n
                row["self_ms"] += v["self_ms"] / n
                row["kernels"] += v["kernels"] / n
                if path in (("step",), ("step.bwd",)):
                    free += v["self_ms"]
            out["unspanned_ms"][kind] += free / n
    out["outside_non_port_ms"] = sum(
        (b - a) * 1e3 for i, (name, a, b) in enumerate(ev)
        if i not in inside and not tracing.is_port(name)) / n
    return out


def ms_under(t: dict, kinds, pred) -> float:
    """Device ms a step of the outermost spans whose name passes ``pred``,
    in the maps of ``kinds`` ("fwd", "bwd")."""
    s = 0.0
    for kind in kinds:
        for path, row in t[kind].items():
            if pred(path[-1]) and not any(pred(p) for p in path[:-1]):
                s += row["ms"]
    return s


def _print(t: dict):
    w = sys.stderr.write
    w(f"span table: device ms a step over {t['steps']} traced steps "
      f"(ms, self ms, kernels)\n")
    for kind in ("fwd", "bwd"):
        if not t[kind]:
            continue
        w(f"  {kind} graph: replay {t['replay_ms'][kind]:.4f} ms, "
          f"unspanned {t['unspanned_ms'][kind]:.4f} ms\n")
        for path, row in sorted(t[kind].items()):
            w(f"    {'  ' * (len(path) - 1)}{path[-1]:<22} "
              f"{row['ms']:10.4f} {row['self_ms']:10.4f} "
              f"{row['kernels']:8.1f}\n")
    replay = sum(t["replay_ms"].values())
    w(f"  replays {replay:.4f} ms, their port kernels {t['port_ms']:.4f} "
      f"ms, non-port {replay - t['port_ms']:.4f} ms; non-port outside "
      f"the replays (copies, clones, chi-square) "
      f"{t['outside_non_port_ms']:.4f} ms\n")


def _print_setup():
    """The program's set-up spans of each captured step (log.SETUP):
    host seconds of the warm-up calls, the capture, and the part of the
    capture the layer maps' bookkeeping took."""
    log, _ = _maps()
    for key, spans in getattr(log, "SETUP", {}).items():
        if key[0] == "make_forward":
            sys.stderr.write(f"  set-up of {key[1]}: " + ", ".join(
                f"{n} {s:.4f} s" for n, s in spans) + "\n")
