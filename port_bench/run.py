#!/usr/bin/env python3
"""One run of one cell of the port's benchmark.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout, on a machine with a CUDA card.  Set-up
builds the cell's inputs from the seed, the program's model
(transit_tpu_torch.TransitModel) and its compiled step (make_forward),
and captures and warms the step; then the closed loop of one caller
(harness/loop.py) runs for ``--seconds``.  With ``--trace 1`` a fixed
slice of the window runs under torch.profiler and the run reports the
cell's per-layer metrics (port_bench/metrics/<name>.py), else its
end-to-end metrics.  After the window the program is freed and the
kept steps' outputs are compared with the plain reference
(port_bench/reference).  The last line of standard output is the
result, one JSON object; the numbers compared, beside their limits,
are the last lines of standard error.

``--control 1`` runs no program: the reference in float32 with TF32
products takes its place on the same checked profiles, and the run
prints the numbers it reads (the control of the correctness check).
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# Top-level module names that must not be loaded in a run.
FORBIDDEN = ("jax", "jaxlib", "flax", "transit_tpu")


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def build_program(cell, tli_path, device):
    """The program's model of the cell's configuration and its compiled
    step: (model, step, seconds the model's constructor took)."""
    import torch
    from transit_tpu_torch.config import TransitConfig
    from transit_tpu_torch.model import TransitModel

    c = dict(cell.config["transit"])
    for k in ("atm", "molfile", "linedb"):
        c[k] = str(ROOT / c[k])
    if tli_path is not None:
        c["linedb"] = str(tli_path)
    c["csfile"] = ",".join(str(ROOT / f) for f in c["csfile"].split(","))
    m = cell.config["model"]
    kw = dict(mode=m["mode"], dtype=getattr(torch, m["dtype"]),
              device=device)
    if m.get("bands"):
        kw["bands"] = m["bands"]
    t = time.perf_counter()
    model = TransitModel(TransitConfig(**c), **kw)
    setup = time.perf_counter() - t
    return model, model.make_forward(), setup


@dataclasses.dataclass
class Context:
    """What a per-layer metric reader (port_bench/metrics/<name>.py,
    ``read(ctx)``) reads: the cell, the traced slice
    (harness/tracing.Slice), the host timings, and the work the slice's
    inputs need (:meth:`per_step`)."""
    cell: object
    slice: object
    host: dict
    loop: object
    ref: object
    cache: dict = dataclasses.field(default_factory=dict)

    def per_step(self, key: str, fn) -> dict:
        """The mean over the slice's steps of the sum over each step's
        profiles of ``fn(ref, T, q)`` (a dict of counts), each profile's
        counts computed once; printed to standard error the first time."""
        if key in self.cache:
            return self.cache[key]
        loop, a = self.loop, self.cell.traffic["trace_start"]
        steps = range(a, a + self.slice.steps)
        each, total = {}, {}
        for i in steps:
            for k in loop.members(i):
                if k not in each:
                    each[k] = fn(self.ref, loop.T[k].double(),
                                 loop.q[k].double())
                for n, v in each[k].items():
                    total[n] = total.get(n, 0) + v
        out = self.cache[key] = {n: v / len(steps) for n, v in total.items()}
        print(f"work a step ({key}): {json.dumps(out)}", file=sys.stderr)
        return out


def make_inputs(cell, seed: int, tmp: Path, device, dtype):
    """The run's inputs, made from the seed: (the line list the program
    reads, or None for the configuration's own; the pool of (T, q); the
    observed spectrum and its sigma).  Only the files these need are read
    (the atmosphere, and the list a configuration splits); the
    reference's own loading waits until after the window."""
    import numpy as np
    from port_bench.harness import traffic
    from port_bench.reference.inputs import read_atmosphere, read_tli
    from port_bench.reference.model import wn_grid

    c = cell.config["transit"]
    tli_path = None
    if cell.config.get("lines"):
        tli_path = tmp / "lines.tli"
        traffic.write_line_list(tli_path, read_tli(ROOT / c["linedb"]),
                                cell.config, seed)
    atm = read_atmosphere(ROOT / c["atm"], ROOT / c["molfile"])
    pool = traffic.make_pool(atm, cell.traffic, seed, device, dtype)
    wn0, dwn, nwn = wn_grid(c)
    obs, sigma = traffic.make_obs(wn0 + dwn * np.arange(nwn), cell.traffic,
                                  seed, device, dtype)
    return tli_path, pool, obs, sigma


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             control: bool = False) -> dict:
    import numpy as np
    import torch
    from port_bench.harness import check, loop as loop_mod, tracing
    from port_bench.harness.spec import metric_reader
    from port_bench.reference.inputs import load_problem
    from port_bench.reference.model import Reference

    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    tr = cell.traffic
    dtype = getattr(torch, cell.config["model"]["dtype"])
    tmp = Path(tempfile.mkdtemp(prefix="port_bench_"))
    try:
        parts = {"start": time.perf_counter() - T0}
        t = time.perf_counter()
        tli_path, pool, obs, sigma = make_inputs(cell, seed, tmp, device,
                                                 dtype)
        parts["inputs"] = time.perf_counter() - t
        if control:
            loop = loop_mod.Loop(None, pool, obs, sigma, tr)
            kept = {i: None for i in loop_mod.check_steps(tr, seed)}
            if tr.get("check_last", True):
                kept[tr["check_span"]] = None
            checked = load_problem(cell.config, ROOT, tli_path)
            ref = Reference(checked, device)
            out = {"control": cell.limits["control"]}
            # The control's readings, and beside them those of the
            # reference in float32 with full-precision products (the
            # floor a float32 program reaches).
            for key, kind in (("readings", cell.limits["control"]),
                              ("float32", "float32")):
                ctrl = check.control_reference(checked, device, kind)
                out[key] = check.readings(ref, loop, kept,
                                          tr["check_members"], seed,
                                          check.control_outputs(ctrl, loop))
                del ctrl
            return {**out, "limits": check.compared(cell.limits)}

        t = time.perf_counter()
        model, fwd, model_setup_s = build_program(cell, tli_path, device)
        parts["model"] = time.perf_counter() - t
        loop = loop_mod.Loop(fwd, pool, obs, sigma, tr)
        t = time.perf_counter()
        loop.step(0)                   # the capture of the cell's step
        sync()
        capture_s = parts["capture"] = time.perf_counter() - t
        t = time.perf_counter()
        for i in (1, 2):
            loop.step(i)
        sync()
        parts["warm"] = time.perf_counter() - t
        setup_s = time.perf_counter() - T0

        win = loop_mod.run(loop, seconds, tr, seed, trace, sync)
        sync()
        peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        n = win.steps * loop.B
        metrics = {"setup_s": {"value": setup_s, "unit": "s"}}
        rate = "gradients_per_s" if loop.grad else "spectra_per_s"
        metrics[rate] = {"value": n / win.seconds,
                         "unit": "gradients/s" if loop.grad else "spectra/s"}
        metrics["step_p95_ms"] = {"value": float(np.percentile(
            win.step_s, 95)) * 1e3, "unit": "ms"}
        failed = win.failed * loop.B

        # The program's state goes before the reference runs.
        loop.fwd = None
        del fwd, model
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        t = time.perf_counter()
        ref = Reference(load_problem(cell.config, ROOT, tli_path), device)
        ref_setup_s = time.perf_counter() - t

        result = {"attempted": n, "failed": failed}
        dev = {"platform": "gpu" if cuda else "cpu",
               "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
               "count": 1, "memory_peak_bytes": int(peak)}
        want = {m["name"]: m for m in cell.end_to_end}
        if trace:
            sl = win.trace
            ctx = Context(cell=cell, slice=sl, loop=loop, ref=ref,
                          host={"setup_s": setup_s, "capture_s": capture_s,
                                "model_setup_s": model_setup_s})
            per = {}
            for m in cell.per_layer:
                v = metric_reader(m["name"])(ctx)
                if v is not None:
                    per[m["name"]] = {"value": v, "unit": m["unit"]}
            result["metrics"] = per
            dev["busy_s"] = tracing.busy_seconds(sl)
            dev["window_s"] = sl.seconds
            result["breakdown"] = tracing.breakdown(sl)
        else:
            result["metrics"] = {k: v for k, v in metrics.items()
                                 if k in want}
        result["device"] = dev
        t = time.perf_counter()
        numbers = check.readings(ref, loop, win.kept, tr["check_members"],
                                 seed)
        result["setup_parts"] = parts
        result["check_s"] = {"reference_setup": ref_setup_s,
                             "comparison": time.perf_counter() - t,
                             "profiles": len(win.kept) * min(
                                 loop.B, tr["check_members"])}
        limits = check.compared(cell.limits)
        result["correct"] = check.verdict(numbers, limits) and failed == 0
        result["also_read"] = {k: v for k, v in numbers.items()
                               if k not in limits}
        result["checks"] = {k: {"value": numbers[k], "limit": v}
                            for k, v in limits.items()}
        return result
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None) -> int:
    a = parse(argv)
    import torch
    from port_bench.harness.spec import load_cell

    cell = load_cell(a.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"port_bench: {a.workload} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    res = run_cell(cell, a.seed, a.seconds, bool(a.trace),
                   torch.device("cuda"), control=bool(a.control))
    found = forbidden_modules()
    if found:
        print(f"port_bench: the run loaded {found}", file=sys.stderr)
        return 3
    if a.control:
        print(json.dumps(res))
        return 0
    checks = res.pop("checks")
    for k, v in checks.items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    out = {"correct": res.pop("correct"), "attempted": res.pop("attempted"),
           "failed": res.pop("failed"), "metrics": res.pop("metrics"),
           "device": res.pop("device"), **res, "checks": checks}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
