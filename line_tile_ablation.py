"""Where the line kernels' time goes, by ablation, on one NVIDIA GPU.

    python3 line_tile_ablation.py             # line_tile_extinction
    python3 line_tile_ablation.py backward    # the two backward kernels
    python3 line_tile_ablation.py profile     # exact mode's two kernels

Builds the port's kernels (transit_tpu_torch/csrc) as they are and in
variants that each leave out or simplify one phase (ABLATIONS, per suite:
text substitutions keyed by source file), all with nvcc in parallel into
build/transit_tpu_torch/ablation/<suite>/, and times each variant on the
suite's targets (TARGETS) in turns, the kernels as they are first and
last:
- forward: line_tile_extinction on the unbanded hot-Jupiter plan of
  chip_smoke.py, CUDA events around the call (chip_smoke.cuda_ms);
- backward: line_tile_backward's and shell_tile_backward's launches of
  one gradient step on the banded hot-Jupiter paths (the main path, 0.5
  cm-1; and 0.05 cm-1, the only one with a shell launch), device time of
  the launches captured ten times in a CUDA graph and replayed
  (chip_smoke.graph_ms);
- profile: profile_scatter and profile_scatter_backward on exact mode's
  hot-Jupiter groups at the file's temperatures (chip_smoke's exact
  phases: hj_ref.cfg), timed as the backward suite's.
A variant computes something else, so only its time means anything; the
differences between times say what each phase costs, as far as phases
do not overlap.  Prints the card's name and power limit, one line per
timing and, last, one JSON object of all times in ms.  Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys

import torch

import chip_smoke as cs
from transit_tpu_torch.opacities import _build, banded, kernel_lbl

# suite -> name -> (what it leaves out or changes, {source: [(text,
# replacement), ...]}); every occurrence of a text is replaced.
ABLATIONS = {
    "forward": {
        "no_chunks": (
            "every chunk: only the block prologue (line window) and the "
            "output",
            {"line_tile.cu": [("c0 < jhi; c0 += CH", "c0 < jlo; c0 += CH")]}),
        "empty_chunks": (
            "the set-up work: chunks stage lines, scan and sync, find "
            "nothing",
            {"line_tile.cu": [("if (setup && j < cn && rw.iso[j] >= 0) {",
                               "if (setup && j < cn && rw.iso[j] < -1) {")]}),
        "setup_only": (
            "the pairs: set-up and compaction run, nothing is evaluated",
            {"line_tile.cu": [("const int P = (int)(total & 0x1fffff);",
                               "const int P = 0 * (int)(total & 0x1fffff);")]}),
        "no_voigt": (
            "the Voigt function (x + y stands in for K(x, y))",
            {"line_tile.cu": [("voigt_k<WFN>(x, s_y[e])", "(x + s_y[e])")]}),
        "no_owner": (
            "the owners' walk and sum",
            {"line_tile.cu": [("        if (!o_on[o]) continue;",
                               "        if (!o_on[o] || jhi >= 0) continue;")]}),
    },
    "backward": {
        "prologue_only": (
            "every chunk: only the block prologue (staging of the layers' "
            "values and of g, the line window; the shell's gp) and the flush",
            {"line_tile.cu": [("c0 < jhi; c0 += BNE) {",
                               "c0 < jlo; c0 += BNE) {")],
             "shell_tile.cu": [
                 ("    for (int c0 = 0; c0 < cnt; c0 += SB_LINES) {",
                  "    for (int c0 = 0; c0 < 0; c0 += SB_LINES) {")]}),
        "no_pairs": (
            "the pairs: set-up and chain run on zero sums",
            {"line_tile.cu": [("  for (int b = b0; b <= b1; ++b) {",
                               "  for (int b = b0; b < b0; ++b) {")],
             "shell_tile.cu": [("  for (int p = 0; p < ne; ++p) {",
                                "  for (int p = 0; p < 0; ++p) {")]}),
        "no_voigt": (
            "the Voigt pair (x + y and x - y stand in for w)",
            {"voigt.cuh": [("  voigt_w<WFN>(x, y, wr, wi);",
                            "  wr = x + y;\n  wi = x - y;")]}),
        "plain_cell_adds": (
            "the warp aggregation and shared atomics of the cells (racy "
            "adds; the registers' flush included)",
            {"voigt.cuh": [
                ("  const unsigned grp = __match_any_sync(FULL, key);",
                 "  const unsigned grp = 1u << lane;"),
                ("      if (t[i] != 0.0) atomicAdd(red + cell + i * "
                 "step, t[i]);",
                 "      if (t[i] != 0.0) red[cell + i * step] += t[i];")]}),
        "two_blocks": (
            "nothing: at most two blocks an SM (launch bounds (256, 1): "
            "the compiler's own register count)",
            {"line_tile.cu": [("__launch_bounds__(BT, 3)",
                               "__launch_bounds__(BT)")],
             "shell_tile.cu": [("__launch_bounds__(SNT, 3)",
                                "__launch_bounds__(SNT)")]}),
    },
    "profile": {
        "no_bins": (
            "every bin: the tile's windows, its span and the segment's "
            "zeroing or staging and flush run, no bin is added",
            {"profile_scatter.cu": [
                ("for (int j = win.minj; j <= win.maxj; ++j) {",
                 "for (int j = win.minj; j < win.minj; ++j) {")]}),
        "first_bin": (
            "every bin of a window after its first",
            {"profile_scatter.cu": [
                ("for (int j = win.minj; j <= win.maxj; ++j) {",
                 "for (int j = win.minj; j <= win.minj; ++j) {")]}),
        "eight_bins": (
            "the bins of a window after its eighth (the tail of windows "
            "of 9-30 bins)",
            {"profile_scatter.cu": [
                ("for (int j = win.minj; j <= win.maxj; ++j) {",
                 "for (int j = win.minj; j <= min(win.maxj, win.minj + 7); "
                 "++j) {")]}),
        "no_table": (
            "the table reads (k, or the cotangent, stands in for the "
            "product)",
            {"profile_scatter.cu": [
                ("__fmul_rn(k, profflat[win.pbase + f])", "k"),
                ("__fmul_rn(profflat[win.pbase + f], row[j - base])",
                 "row[j - base]")]}),
        "no_flush": (
            "the forward's flush of the segment to the output",
            {"profile_scatter.cu": [
                ("if (v != 0.0f) atomicAdd(row + lo + i, v);",
                 "if (v != 0.0f && lo < 0) atomicAdd(row + lo + i, v);")]}),
    },
}


def build_variants(suite: str) -> dict:
    """Compile the sources as they are and each of the suite's ablations,
    one nvcc each, all at once; name -> CDLL."""
    out = _build.BUILD_DIR / "ablation" / suite
    procs = {}
    for name, (_, subs) in {"as_is": ("", {}), **ABLATIONS[suite]}.items():
        d = out / name
        d.mkdir(parents=True, exist_ok=True)
        for src in _build.sources():
            text = src.read_text()
            for old, new in subs.get(src.name, []):
                if old not in text:
                    raise RuntimeError(f"ablation {name}: {old!r} is not in "
                                       f"{src.name}")
                text = text.replace(old, new)
            (d / src.name).write_text(text)
        so = d / "lib.so"
        procs[name] = (so, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-shared", "-o",
             str(so), *(str(d / s.name) for s in _build.sources()
                        if s.suffix == ".cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(str(so))
        for fn, argtypes in _build.SIGNATURES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def forward_targets() -> dict:
    """{target: (fn, timer)}: the unbanded line-tile launch."""
    hj = cs.TransitModel(cs.hotjupiter_config(), mode="fast",
                         dtype=torch.float32, device="cuda")
    args, kw = cs.file_state(hj)
    tab = kernel_lbl.layer_tables(hj.fdev, *args)
    return {"unbanded line_tile_extinction": (
        lambda: kernel_lbl.line_tile_extinction(hj.fplan, hj.fdev, tab,
                                                args[0], **kw),
        lambda fn: cs.cuda_ms(fn, runs=11))}


def backward_targets() -> dict:
    """{target: (fn, timer)}: per banded path and backward kernel, that
    kernel's launches of one gradient step, on the file atmosphere and
    the cotangent of the spectrum's sum (the clip masks from the kernels
    as they are)."""
    out = {}
    for label, wndelt in (("main", 0.5), ("0.05", 0.05)):
        m = cs.TransitModel(cs.hotjupiter_config(wndelt), mode="fast",
                            dtype=torch.float32, device="cuda", bands=6)
        args, kw = cs.file_state(m)
        T = args[0]
        tab = banded.prep_layers(m.bdev[0], *args, use_kernel=True)
        g = cs.line_cotangent(m, m.atm.temp, m.atm.q)
        launches = list(cs.backward_launches(m))
        clips = {id(u): cs.shell_clip(tab, T, kw, u, r, m.wns.n)
                 for p, u, r, _ in launches if p == "shell"}
        for name in ("line_tile_backward", "shell_tile_backward"):
            mine = [x for x in launches if cs.bwd_name(x[0]) == name]
            if mine:
                out[f"{label} {name}"] = (
                    lambda mine=mine, tab=tab, T=T, kw=kw, g=g, clips=clips: [
                        cs.backward_kernel(tab, T, kw, p, u, r, g,
                                           clips.get(id(u)))
                        for p, u, r, _ in mine],
                    lambda fn: cs.graph_ms(fn, n=10))
    return out


def profile_targets() -> dict:
    """{target: (fn, timer)}: one launch of each profile-scatter kernel
    on the exact model's groups at the file's temperatures (the backward
    on the cotangent of the spectrum's sum)."""
    cfg = cs.exact_config()
    m = cs.TransitModel(cfg, dtype=torch.float32, device="cuda",
                        table=cs.exact_table(cfg, "cuda"))
    grp, s = cs.exact_groups(m)
    args = (grp["g_k"], grp["g_idop"], grp["ilor"], s)
    ct = cs.line_cotangent(m, m.atm.temp, m.atm.q)

    def timer(fn):
        return cs.graph_ms(fn, n=10)

    return {"exact profile_scatter": (
                lambda: cs.profile_scatter(*args), timer),
            "exact profile_scatter_backward": (
                lambda: cs.profile_scatter_backward(ct, grp["keep"],
                                                    *args[1:]), timer)}


TARGETS = {"forward": forward_targets, "backward": backward_targets,
           "profile": profile_targets}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("suite", nargs="?", default="forward", choices=TARGETS)
    suite = ap.parse_args(argv).suite
    if not torch.cuda.is_available():
        print("line_tile_ablation: needs a CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    libs = build_variants(suite)
    targets = TARGETS[suite]()
    load = _build.load_library
    times = {}
    try:
        for name in [*libs, *reversed(libs)]:
            _build.load_library = lambda lib=libs[name]: lib
            what = ABLATIONS[suite][name][0] if name != "as_is" else "nothing"
            for target, (fn, timer) in targets.items():
                ms = timer(fn)
                times.setdefault(target, {}).setdefault(name, []).append(ms)
                print(f"{target} {name}: {ms:.4f} ms (leaves out {what})",
                      flush=True)
    finally:
        _build.load_library = load
    print(json.dumps({"card": card, "suite": suite, "ms": times}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
