"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile chiprun_out/forward_trace.json]

Builds the port's CUDA kernels (the line-tile kernel and the per-layer
kmax scan) from the sources in this checkout, holds each against its
plain PyTorch version on the card, drives the main path —
``transit_tpu_torch.model.TransitModel(mode="fast", use_kernel=True)`` on
the hot-Jupiter workload (benchmarks/data/hj: 100 layers, 19001
wavenumbers, 194,349 lines, eclipse) — through three ``forward``
requests, checks the spectra against the plain path and the reference C
spectrum, checks that the line-tile kernel evaluated exactly the (layer,
bin, line) pairs the function needs, and times the kernels, their plain
versions and one ``forward`` with CUDA events.  With ``--profile`` it
also traces forwards with torch.profiler (device time by kernel, busy
share).  Every phase prints
one line with its seconds; any failed check raises, so the script exits non-zero and prints no result.

Output, last three lines: the card's name and power limit as nvidia-smi
gives them precedes them; then one ``{"kernels": [...]}`` JSON object and,
last, ``{"ok": true, "device": {...}}``.  Without a CUDA device it exits
with code 1 at once.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from transit_tpu_torch.config import TransitConfig
from transit_tpu_torch.model import TransitModel
from transit_tpu_torch.opacities import _build
from transit_tpu_torch.opacities.kernel_lbl import (
    kernel_extinction, layer_kmax, layer_tables, line_tile_extinction,
    plain_extinction, plain_kmax, run_counts, strength_coef, work_counts)

ROOT = Path(__file__).resolve().parent
FIX = ROOT / "tests" / "fixtures"
HJ = ROOT / "benchmarks" / "data" / "hj"
HJ_SHAPE = (19001, 100)        # wavenumbers, layers

# Kernel against its plain version: max |a-b| / (|a| + 1e-6 max|a|), the
# bound of the JAX package's Pallas-vs-XLA test (tests/test_pallas.py:35).
KERNEL_REL_TOL = 1e-5
# Spectra of the kernel path against the plain path (float32 sums in
# another order: ~1e-6 expected).
SPECTRUM_REL_TOL = 1e-4
# Median |flux/C - 1| against the reference C spectrum (the JAX fast mode
# recorded 0.23% on these files, benchmarks/RESULTS.md:253).
C_MEDIAN_TOL = 1e-2
RUNS = 5

# H100 SXM peaks at the full 700 W power limit (NVIDIA data sheet): FP32
# outside the tensor cores, and HBM3 bandwidth.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# Operations the line-tile function needs, whatever the design (an add,
# a multiply, a compare or a max is one, a divide or an exp one): per
# (layer, line) of the line list, 19 for the strength and width chain
# (k0, the ethresh test, k, alphaD, 1/alphaD, y, the wing) and 8 to find
# the run of bins inside the wing; per Voigt evaluation of a kept line
# inside its wing, 7 for the distance, x, the 1/alphaD and k products and
# the sum, plus the Humlicek region's own count (csrc/line_tile.cu).
OPS_LAYER_LINE = 27
OPS_EVAL = 7
OPS_REGION = {"II": 48, "III": 82, "IV": 120}
# Operations of the kmax scan per (layer, line): the strength chain k0
# (2 multiplies and 2 divides into the exps, 2 exps, a subtract, 3
# multiplies) and the max.
OPS_KMAX = 12


class CheckFailed(RuntimeError):
    pass


def check(cond, msg: str):
    if not cond:
        raise CheckFailed(msg)


def phase(name: str, t0: float, text: str = ""):
    print(f"phase {name}: {time.perf_counter() - t0:.2f} s {text}".rstrip(),
          flush=True)


def fixture_config() -> TransitConfig:
    """The repo's conformance fixture (tests/fixtures: 20 layers, 101
    wavenumbers, eclipse)."""
    return TransitConfig(
        atm=f"{FIX}/test.atm", linedb=f"{FIX}/test.tli",
        csfile=f"{FIX}/test_cia.dat", molfile=f"{FIX}/molecules.dat",
        wnlow=2000.0, wnhigh=2100.0, wndelt=1.0, wnosamp=216, wnfct=1.0,
        nwidth=20.0, ethreshold=1e-8, solution="eclipse", toomuch=1e30)


def hotjupiter_config() -> TransitConfig:
    """The hot-Jupiter workload (bench.py:208-240, hj_ref.cfg)."""
    return TransitConfig(
        atm=f"{HJ}/hj.atm", linedb=f"{HJ}/hj.tli",
        csfile=f"{HJ}/cia_H2_H2.dat,{HJ}/cia_H2_He.dat",
        molfile=f"{HJ}/molecules.dat", wnlow=500.0, wnhigh=10000.0,
        wndelt=0.5, wnosamp=2160, wnfct=1.0, nwidth=20.0, ethreshold=1e-8,
        solution="eclipse", toomuch=1e30)


def file_state(m: TransitModel):
    """Line-extinction arguments for the model's file atmosphere."""
    temps_raw = m._t(m.atm.temp)
    args = (temps_raw * m.atm.tfct, m._t(m.atm.d), m.partition(temps_raw),
            m._molm_t, m._molrad_t)
    kw = dict(wn_i=m.wns.i, dwn=m.wns.d, ethresh=m.cfg.ethreshold,
              nwidth=m.cfg.nwidth)
    return args, kw


def kernel_vs_plain(m: TransitModel, label: str):
    """Kernel and plain version on the same inputs, on the card."""
    args, kw = file_state(m)
    a = plain_extinction(m.fplan, m.fdev, *args, **kw)
    b = kernel_extinction(m.fplan, m.fdev, *args, **kw)
    torch.cuda.synchronize()
    check(a.shape == b.shape == (m.atm.nlayers, m.wns.n),
          f"{label}: shapes {tuple(a.shape)} {tuple(b.shape)}")
    check(bool(torch.isfinite(b).all()), f"{label}: kernel output not finite")
    check(float(a.max()) > 0, f"{label}: plain extinction is all zero")
    diff = (a - b).abs()
    rel = diff / (a.abs() + 1e-6 * a.abs().max())
    worst = float(rel.max())
    if not worst < KERNEL_REL_TOL:
        flat = torch.topk(rel.flatten(), 10).indices
        for i in flat.tolist():
            layer, col = divmod(i, m.wns.n)
            print(f"  {label}: layer {layer} bin {col} "
                  f"(wn {m.wns.v[col]:.4f}) plain {float(a[layer, col]):.7e}"
                  f" kernel {float(b[layer, col]):.7e} "
                  f"rel {float(rel[layer, col]):.3e}")
    check(worst < KERNEL_REL_TOL,
          f"{label}: kernel vs plain {worst:.3e} >= {KERNEL_REL_TOL}")
    return {"max_rel": worst, "max_abs": float(diff.max()),
            "shape": [m.atm.nlayers, m.fplan.ntiles, m.fplan.lmax,
                      m.fplan.tw]}


def kmax_vs_plain(m: TransitModel, label: str) -> float:
    """layer_kmax against plain_kmax on the same inputs, on the card:
    they must agree bit for bit (a max does not depend on order, and
    both round each operation the same way).  Returns max |a - b|."""
    args, _ = file_state(m)
    coef0 = strength_coef(m.fdev, args[2])
    a = plain_kmax(m.fdev, args[0], coef0)
    b = layer_kmax(m.fdev, args[0], coef0)
    torch.cuda.synchronize()
    check(a.shape == b.shape == (m.atm.nlayers,) and
          bool(torch.isfinite(a).all()),
          f"{label}: kmax shapes {tuple(a.shape)} {tuple(b.shape)}")
    if not torch.equal(a, b):
        i = int((a != b).nonzero()[0])
        raise CheckFailed(f"{label}: layer_kmax differs from plain kmax "
                          f"at layer {i}: {float(a[i])!r} {float(b[i])!r}")
    return float((a - b).abs().max())


def design_counts(m: TransitModel, tab, counts) -> dict:
    """The line-tile kernel's own work on the model's file atmosphere:
    its counters (chains computed, live entries, pairs evaluated) from
    one launch, checked against the host count of the same design
    (run_counts) and against the Voigt evaluations the function needs
    (work_counts: no dead pair reaches the Voigt)."""
    args, kw = file_state(m)
    host = run_counts(m.fplan, m.fdev, tab, args[0], **kw)
    stats = torch.zeros(3, dtype=torch.int64, device=args[0].device)
    line_tile_extinction(m.fplan, m.fdev, tab, args[0], **kw, stats=stats)
    card = dict(zip(("chains", "live", "pairs"), stats.tolist()))
    check(card == host, f"kernel counters {card} != design {host}")
    need = sum(counts[r] for r in OPS_REGION)
    check(card["pairs"] == need,
          f"kernel evaluated {card['pairs']} pairs, the function needs "
          f"{need}")
    return card


def cuda_ms(fn, runs: int = RUNS) -> float:
    """Median of ``runs`` CUDA-event timings of fn() after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def roofline(ops: float, nbytes: float) -> tuple:
    """(bound_ms, bound_by): the larger of the operation and byte times
    at the card's peaks."""
    t_ops, t_bytes = ops / PEAK_FP32, nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def kmax_bound(m: TransitModel) -> tuple:
    """(bound_ms, bound_by, ops, bytes) of the kmax scan."""
    d = m.fdev
    nl, nlines = m.atm.nlayers, d["all_wavn"].shape[0]
    ops = OPS_KMAX * nl * nlines
    nbytes = sum(d[k].numel() * d[k].element_size()
                 for k in ("all_wavn", "all_elow", "all_gf", "all_iso"))
    nbytes += 4 * nl * (2 + d["iso_mass"].shape[0])  # temps, coef0, kmax
    return (*roofline(ops, nbytes), ops, nbytes)


def bound(m: TransitModel, tab, counts) -> tuple:
    """(bound_ms, bound_by, ops, bytes) of the line-tile function."""
    ops = (OPS_LAYER_LINE * counts["layer_lines"] +
           sum((OPS_EVAL + OPS_REGION[r]) * counts[r] for r in OPS_REGION))
    d = m.fdev
    nbytes = sum(d[k].numel() * d[k].element_size()
                 for k in ("wavn", "elow", "gf", "iso", "mask"))
    nbytes += sum(t.numel() * t.element_size() for t in tab.values())
    nbytes += 4 * m.atm.nlayers * (1 + m.wns.n)       # temps in, output
    return (*roofline(ops, nbytes), ops, nbytes)


def profile_forward(m: TransitModel, T, q, ms_forward: float,
                    trace: str) -> None:
    """Trace RUNS forwards with torch.profiler and print the device time
    per kernel name (per forward) and the device-busy share: summed device
    time of one forward over its CUDA-event time ``ms_forward``.  The
    Chrome trace goes to ``trace``."""
    from torch.autograd import DeviceType

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(RUNS):
            m.forward(T, q)
        torch.cuda.synchronize()
    Path(trace).parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(trace)
    # Device-side events only (kernels, copies): an aten op's row repeats
    # the device time of the kernels it launched.
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = ev.self_cuda_time_total
        rows.append((dev_us / RUNS / 1e3, ev.count // RUNS, ev.key))
    rows.sort(reverse=True)
    dev_ms = sum(r[0] for r in rows)
    check(dev_ms > 0, "the profiler recorded no device time")
    print(f"profile: device time {dev_ms:.3f} ms per forward, busy share "
          f"{dev_ms / ms_forward:.3f} of {ms_forward:.3f} ms; "
          f"{sum(r[1] for r in rows)} device kernels per forward, "
          f"{len(rows)} names; trace {trace}", flush=True)
    for ms, n, key in rows[:15]:
        print(f"profile: {ms:10.4f} ms {n:5d} x {key[:90]}", flush=True)


def main(device: str = "cuda", profile: str | None = None) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the smoke run needs one card",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    dev = torch.device(device)

    # 1. The card.
    t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    card = smi[torch.cuda.current_device()] if smi else ""
    check(card, "nvidia-smi printed no card")
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    phase("card", t0)

    # 2. Build the kernels from this checkout's sources.
    t0 = time.perf_counter()
    so = _build.build(verbose=True)
    _build.load_library()
    phase("build", t0, f"({so.relative_to(ROOT)})")

    # 3. Kernels against their plain versions at the fixture and
    #    hot-Jupiter shapes, float32.
    t0 = time.perf_counter()
    fix = TransitModel(fixture_config(), dtype=torch.float32, device=dev)
    kmax_vs_plain(fix, "fixture")
    err_fix = kernel_vs_plain(fix, "fixture")
    phase("kernel_vs_plain_fixture", t0,
          f"max_rel {err_fix['max_rel']:.3e} (nl, ntiles, lmax, tw) "
          f"{err_fix['shape']}")
    t0 = time.perf_counter()
    hj = TransitModel(hotjupiter_config(), dtype=torch.float32, device=dev)
    check((hj.wns.n, hj.atm.nlayers) == HJ_SHAPE,
          f"hot-Jupiter grid {hj.wns.n} x {hj.atm.nlayers}")
    nlines = hj.fplan.wavn.shape[0]
    torch.cuda.synchronize()
    phase("hotjupiter_model_setup", t0,
          f"{nlines} lines, {hj.fplan.ntiles} tiles, lmax "
          f"{hj.fplan.lmax}, tw {hj.fplan.tw}")
    t0 = time.perf_counter()
    kmax_err = kmax_vs_plain(hj, "hotjupiter")
    phase("kmax_vs_plain", t0, f"layer_kmax equals plain kmax bitwise on "
          f"the fixture and on {hj.atm.nlayers} hot-Jupiter layers "
          f"(max_abs {kmax_err!r})")
    t0 = time.perf_counter()
    err_hj = kernel_vs_plain(hj, "hotjupiter")
    phase("kernel_vs_plain_hotjupiter", t0,
          f"max_rel {err_hj['max_rel']:.3e} max_abs {err_hj['max_abs']:.3e}")

    # 4. The main path: three retrieval requests through the kernel.
    t0 = time.perf_counter()
    T0 = np.asarray(hj.atm.temp, dtype=np.float64)
    q0 = np.asarray(hj.atm.q, dtype=np.float64)
    requests = [(T0, q0), (T0 + 50.0, q0), (T0 - 50.0, q0)]
    kernels = (line_tile_extinction, layer_kmax)
    for k in kernels:
        k.launches = 0
    specs = [hj.forward(T, q) for T, q in requests]
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in kernels}
    phase("main_path", t0, f"3 forward requests, kernel launches "
          f"{launches}")
    for name, n in launches.items():
        check(n >= 3, f"main path launched {name} {n} times")
    t0 = time.perf_counter()
    for s in specs:
        check(s.shape == (hj.wns.n,) and s.dtype == torch.float32,
              f"spectrum {tuple(s.shape)} {s.dtype}")
        check(bool(torch.isfinite(s).all()) and float(s.min()) > 0,
              "spectrum not finite and positive")
    hj.use_kernel = False
    plain_specs = [hj.forward(T, q) for T, q in requests]
    hj.use_kernel = True
    spec_rel = max(float(((a - b).abs() / b.abs()).max())
                   for a, b in zip(specs, plain_specs))
    check(spec_rel <= SPECTRUM_REL_TOL,
          f"kernel path vs plain path {spec_rel:.3e} > {SPECTRUM_REL_TOL}")
    # The C output lists wavelength from 20 um down: ascending wavenumber.
    ref = np.loadtxt(HJ / "hj_ref_spectrum.dat")
    ours = specs[0].double().cpu().numpy()
    wl = 1e4 / hj.wns.v
    check(ref.shape == (hj.wns.n, 2) and
          np.allclose(ref[:, 0], wl, rtol=1e-6),
          "reference C spectrum is on another grid")
    c_rel = np.abs(ours / ref[:, 1] - 1.0)
    c_median = float(np.median(c_rel))
    check(c_median < C_MEDIAN_TOL,
          f"median vs reference C {c_median:.3e} >= {C_MEDIAN_TOL}")
    phase("main_path_checks", t0,
          f"vs plain path max_rel {spec_rel:.3e}; vs reference C median "
          f"{c_median:.4e} (p90 {float(np.quantile(c_rel, 0.9)):.4e})")

    # 5. Times (CUDA events, median of RUNS after a warm-up), and the
    #    line-tile kernel's own work against what the function needs.
    t0 = time.perf_counter()
    args, kw = file_state(hj)
    T = args[0]
    tab = layer_tables(hj.fdev, *args)
    coef0 = tab["coef0"]
    ms_kernel = cuda_ms(lambda: line_tile_extinction(
        hj.fplan, hj.fdev, tab, T, **kw))
    ms_kmax = cuda_ms(lambda: layer_kmax(hj.fdev, T, coef0))
    ms_kmax_plain = cuda_ms(lambda: plain_kmax(hj.fdev, T, coef0))
    ms_wrapper = cuda_ms(lambda: kernel_extinction(hj.fplan, hj.fdev, *args,
                                                   **kw))
    ms_plain = cuda_ms(lambda: plain_extinction(hj.fplan, hj.fdev, *args,
                                                **kw))
    ms_forward = cuda_ms(lambda: hj.forward(T0, q0))
    counts = work_counts(hj.fplan, hj.fdev, tab, T, **kw)
    bound_ms, bound_by, ops, nbytes = bound(hj, tab, counts)
    kb_ms, kb_by, kb_ops, kb_bytes = kmax_bound(hj)
    phase("times", t0,
          f"kernel {ms_kernel:.3f} ms, with prep {ms_wrapper:.3f} ms, plain "
          f"{ms_plain:.3f} ms, forward {ms_forward:.3f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}: {ops:.4e} ops, {nbytes} bytes); "
          f"layer_kmax {ms_kmax:.4f} ms, plain {ms_kmax_plain:.4f} ms, "
          f"bound {kb_ms:.4f} ms ({kb_by}: {kb_ops:.4e} ops, {kb_bytes} "
          f"bytes)")
    print("work " + json.dumps(counts), flush=True)
    t0 = time.perf_counter()
    design = design_counts(hj, tab, counts)
    phase("design_counts", t0, "line-tile kernel counters (equal to the "
          "host count of its design; pairs equal the function's Voigt "
          "evaluations) " + json.dumps(design))
    points = hj.wns.n * hj.atm.nlayers
    print(f"forward: {points / (ms_forward * 1e-3):.6e} wavenumber points x "
          f"layers per second ({ms_forward:.3f} ms, {card})", flush=True)

    # Optional: where one forward spends its device time.
    if profile:
        t0 = time.perf_counter()
        profile_forward(hj, T0, q0, ms_forward, profile)
        phase("profile", t0)

    # 7. Nothing of JAX or of the JAX package was loaded.
    bad = sorted(k for k in sys.modules
                 if k.split(".")[0] in ("jax", "jaxlib", "transit_tpu"))
    check(not bad, f"JAX modules loaded: {bad[:5]}")
    phase("total", t_start)

    # 6. + 8. Result lines, after the card's line.
    print(card, flush=True)
    print(json.dumps({"kernels": [{
        "name": "line_tile_extinction",
        "route": "cuda",
        "source": "transit_tpu_torch/csrc/line_tile.cu",
        "replaces": "transit_tpu/opacities/pallas_lbl.py:38",
        "launches": launches["line_tile_extinction"],
        "max_abs_err": err_hj["max_abs"],
        "max_rel_vs_plain": err_hj["max_rel"],
        "max_rel_vs_plain_fixture": err_fix["max_rel"],
        "ms": ms_kernel,
        "ms_with_prep": ms_wrapper,
        "plain_ms": ms_plain,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "forward_ms": ms_forward,
        "card": card,
    }, {
        "name": "layer_kmax",
        "route": "cuda",
        "source": "transit_tpu_torch/csrc/line_tile.cu",
        "replaces": "transit_tpu/opacities/pallas_lbl.py:127",
        "launches": launches["layer_kmax"],
        "max_abs_err": kmax_err,
        "ms": ms_kmax,
        "plain_ms": ms_kmax_plain,
        "bound_ms": kb_ms,
        "bound_by": kb_by,
        "library_ms": None,
        "card": card,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", metavar="TRACE", default=None,
                    help="also trace forwards with torch.profiler, print "
                    "the device time by kernel and the busy share, and "
                    "write the Chrome trace to TRACE")
    sys.exit(main(profile=ap.parse_args().profile))
