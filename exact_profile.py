"""Profile exact mode's step on one NVIDIA GPU.

    python3 exact_profile.py [--root DIR] [--trace chiprun_out/exact.json]
    python3 exact_profile.py [--root DIR] --exomol K [--seed N]

Builds the kernels of the checkout at DIR (default: this one), sets up
its exact model on benchmarks/data/hj/hj_ref.cfg (as ``chip_smoke.py``'s
exact phases do, through that checkout's own ``chip_smoke`` helpers) and
measures, with this file's :func:`profile_step` whatever the checkout:

  - ``profile_scatter`` and ``profile_scatter_backward`` at the file's
    temperatures (CUDA events, median of 5);
  - ``forward`` and the gradient step (CUDA events, median of 5);
  - a torch.profiler pass of 5 forwards and of 5 gradient steps: device
    ms per step, the busy share (device ms over the events' ms), device
    kernels per step, the port's kernels' device ms and the top device
    operations.

With ``--exomol K`` it measures exact mode on hj.tli's lines split K
ways instead (the checkout's ``chip_smoke.exomol_list``; K = 25 gives
4,858,725 lines), each stage with the device's peak memory counted from
0 (:func:`stage`): the set-up (``TransitModel(cfg)`` on hj_ref.cfg), a
forward without gradient, a gradient step, the kernels against their
plain versions (the checkout's ``exact_vs_plain``) and the spectrum
against the plain path (``check_spectra``); then the forward and the
gradient step (CUDA events, median of 5) and a :func:`profile_step`
pass of each.

It prints the card's name and power limit, then one JSON line.  Two
checkouts compare by running this for each in turns on the same card
(parent, change, change, parent), e.g. with the parent unpacked into
``build/parent`` (``git archive``).  ``chip_smoke.py --profile`` traces
its paths with the same :func:`profile_step`; the kernels' bounds are in
its ``kernels`` line.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

RUNS = 5
# The port's kernels, by the name their device events carry.
PORT_KERNELS = ("line_tile_kernel", "layer_kmax_kernel", "shell_tile_kernel",
                "line_tile_bwd_kernel", "shell_tile_bwd_kernel",
                "profile_scatter_kernel", "profile_scatter_bwd_kernel")


def profile_step(step, ms_step: float, trace: str | None,
                 label: str) -> dict:
    """Trace RUNS calls of ``step`` (a forward, or a gradient step) with
    torch.profiler after one warm-up call, and print the device time per
    kernel name (per call) and the device-busy share: summed device time
    of one call over its CUDA-event time ``ms_step``.  The Chrome trace
    goes to ``trace`` (none when None).  Returns {"device_ms", "busy",
    "kernels" (device kernels per call), "top" (the ten largest device
    operations: [ms, count, name] per call), and each of PORT_KERNELS:
    its device ms per call}."""
    import torch
    from torch.autograd import DeviceType

    step()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(RUNS):
            step()
        torch.cuda.synchronize()
    if trace:
        Path(trace).parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(trace)
    # Device-side events only (kernels, copies): an aten op's row repeats
    # the device time of the kernels it launched.
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA or ev.key.startswith(
                "transit."):       # the program's spans' annotations
            continue
        us = getattr(ev, "self_device_time_total", None)
        us = ev.self_cuda_time_total if us is None else us
        rows.append((us / RUNS / 1e3, ev.count / RUNS, ev.key))
    rows.sort(reverse=True)
    dev_ms = sum(r[0] for r in rows)
    if dev_ms <= 0:
        raise RuntimeError(f"{label}: the profiler recorded no device time")
    res = {"device_ms": dev_ms, "busy": dev_ms / ms_step,
           "kernels": sum(r[1] for r in rows),
           "top": [[ms, n, key[:80]] for ms, n, key in rows[:10]]}
    print(f"profile {label}: device time {dev_ms:.3f} ms per call, busy "
          f"share {res['busy']:.3f} of {ms_step:.3f} ms; "
          f"{res['kernels']:g} device kernels per call, {len(rows)} names; "
          f"trace {trace}", flush=True)
    for ms, n, key in rows[:15]:
        print(f"profile {label}: {ms:10.4f} ms {n:7g} x {key[:90]}",
              flush=True)
    for name in PORT_KERNELS:
        res[name] = sum(r[0] for r in rows if name in r[2])
    print(f"profile {label}: port kernels' device ms per call and share "
          f"of the device time: " + json.dumps(
              {k: [res[k], res[k] / dev_ms] for k in PORT_KERNELS}),
          flush=True)
    return res


def stage(fn) -> tuple:
    """fn() with the device's peak memory counted from 0: (its result,
    the peak allocated GiB while it ran, its seconds)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (out, torch.cuda.max_memory_allocated() / 2 ** 30,
            time.perf_counter() - t)


def exomol_stages(cs, dev, k: int, seed: int) -> dict:
    """Exact mode on hj.tli split ``k`` ways through the checkout's
    chip_smoke helpers (``cs``): each stage's peak GiB and seconds, the
    kernels' and the plain path's distances, forward and gradient ms."""
    import numpy as np
    import torch

    res = {"split": k, "peak_gib": {}, "s": {}}

    def run(name, fn):
        out, res["peak_gib"][name], res["s"][name] = stage(fn)
        return out

    with tempfile.TemporaryDirectory(prefix="exomol_") as tmp:
        lst = cs.exomol_list(Path(tmp), k, seed)
        del lst["lines"]
        cfg = cs.exact_config()
        cfg.linedb = str(lst["path"])
        m = run("setup", lambda: cs.TransitModel(cfg, dtype=torch.float32,
                                                 device=dev))
    res["lines"], res["groups"] = m.plan.n_lines, m.plan.n_groups
    T0 = np.asarray(m.atm.temp, dtype=np.float64)
    q0 = np.asarray(m.atm.q, dtype=np.float64)
    with torch.no_grad():
        spec = run("forward", lambda: m.forward(T0, q0))
    leaves = cs.grad_leaves(m, T0, q0)
    run("gradient", lambda: cs.grad_step(m, *leaves))
    res["vs_plain"] = run("exact_vs_plain", lambda: cs.exact_vs_plain(
        m, cs.line_cotangent(m, T0, q0), "exomol exact"))
    with torch.no_grad():
        res["vs_plain_path"] = run("plain_path", lambda: cs.check_spectra(
            m, [spec], [(T0, q0)], "exomol exact"))
    fwd = cs.nograd(lambda: m.forward(T0, q0))
    res["forward_ms"] = cs.cuda_ms(fwd)
    res["gradient_ms"] = cs.cuda_ms(lambda: cs.grad_step(m, *leaves))
    res["profile_forward"] = profile_step(fwd, res["forward_ms"], None,
                                          f"exomol {k} forward")
    res["profile_grad"] = profile_step(
        lambda: cs.grad_step(m, *leaves), res["gradient_ms"], None,
        f"exomol {k} grad")
    return res


def main(root: Path, trace: str | None, exomol: int | None = None,
         seed: int = 0) -> int:
    sys.path.insert(0, str(root))
    import torch

    import chip_smoke as cs
    import transit_tpu_torch

    pkg = Path(transit_tpu_torch.__file__).resolve()
    if root.resolve() not in pkg.parents:
        raise RuntimeError(f"imported {pkg}, not the checkout at {root}")
    if not torch.cuda.is_available():
        print("exact_profile: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    cs._build.build()
    dev = torch.device("cuda")
    if exomol is not None:
        cs._build.build_host()
        res = {"root": str(root), "card": card,
               **exomol_stages(cs, dev, exomol, seed)}
        print(json.dumps(res), flush=True)
        return 0
    cfg = cs.exact_config()
    m = cs.TransitModel(cfg, dtype=torch.float32, device=dev,
                        table=cs.exact_table(cfg, dev))
    grp, s = cs.exact_groups(m)
    sargs = (grp["g_k"], grp["g_idop"], grp["ilor"], s)
    T0, q0 = m.atm.temp, m.atm.q
    ct = cs.line_cotangent(m, T0, q0)
    kernels = {
        "profile_scatter": cs.cuda_ms(lambda: cs.profile_scatter(*sargs)),
        "profile_scatter_backward": cs.cuda_ms(
            lambda: cs.profile_scatter_backward(ct, grp["keep"], *sargs[1:]))}
    leaves = cs.grad_leaves(m, T0, q0)
    ms_fwd = cs.cuda_ms(lambda: m.forward(T0, q0))
    ms_grad = cs.cuda_ms(lambda: cs.grad_step(m, *leaves))
    stem = Path(trace) if trace else None
    res = {
        "root": str(root), "card": card,
        "pairs": cs.scatter_pairs(*sargs), "kernels_ms": kernels,
        "forward_ms": ms_fwd, "grad_step_ms": ms_grad,
        "profile_forward": profile_step(
            lambda: m.forward(T0, q0), ms_fwd,
            stem and str(stem.with_name(f"{stem.stem}_fwd{stem.suffix}")),
            "exact"),
        "profile_grad": profile_step(
            lambda: cs.grad_step(m, *leaves), ms_grad,
            stem and str(stem.with_name(f"{stem.stem}_grad{stem.suffix}")),
            "exact grad")}
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=Path(__file__).parent,
                    help="the checkout to measure (default: this one)")
    ap.add_argument("--trace", default=None,
                    help="write the Chrome traces beside this path")
    ap.add_argument("--exomol", type=int, default=None, metavar="K",
                    help="measure each stage's peak device memory on "
                    "hj.tli's lines split K ways instead")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the --exomol line list")
    args = ap.parse_args()
    sys.exit(main(args.root.resolve(), args.trace, args.exomol, args.seed))
