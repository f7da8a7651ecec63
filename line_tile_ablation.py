"""Where the line-tile kernel's time goes, by ablation, on one NVIDIA GPU.

    python3 line_tile_ablation.py

Builds the line-tile kernel of transit_tpu_torch/csrc/line_tile.cu as it
is and in variants that each leave out one phase (see ABLATIONS), all with
nvcc in parallel into build/transit_tpu_torch/ablation/, and times each on
the hot-Jupiter inputs of chip_smoke.py with CUDA events, in turns (the
kernel as it is first and last).  A variant computes something else, so
only its time means anything; the differences between times say what each
phase costs, as far as phases do not overlap.  Prints the card's name and
power limit, one line per timing and, last, one JSON object of all times
in ms.  Needs a CUDA device.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import torch

import chip_smoke as cs
from transit_tpu_torch.opacities import _build
from transit_tpu_torch.opacities import kernel_lbl

# name -> (what it leaves out, [(text of the source, replacement), ...])
ABLATIONS = {
    "no_chunks": (
        "every chunk: only the block prologue (line window) and the output",
        [("c0 < jhi; c0 += CH", "c0 < jlo; c0 += CH")]),
    "empty_chunks": (
        "the set-up work: chunks stage lines, scan and sync, find nothing",
        [("if (setup && j < cn && rw.iso[j] >= 0) {",
          "if (setup && j < cn && rw.iso[j] < -1) {")]),
    "setup_only": (
        "the pairs: set-up and compaction run, nothing is evaluated",
        [("const int P = (int)(total & 0x1fffff);",
          "const int P = 0 * (int)(total & 0x1fffff);")]),
    "no_voigt": (
        "the Voigt function (x + y stands in for K(x, y))",
        [("voigt_k<WFN>(x, s_y[e])", "(x + s_y[e])")]),
    "no_owner": (
        "the owners' walk and sum",
        [("        if (!o_on[o]) continue;",
          "        if (!o_on[o] || jhi >= 0) continue;")]),
}


def build_variants() -> dict:
    """Compile the kernel as it is and each ablation; name -> CDLL."""
    src = (_build.CSRC / "line_tile.cu").read_text()
    out = _build.BUILD_DIR / "ablation"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (_, subs) in {"as_is": ("", []), **ABLATIONS}.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"ablation {name}: {old!r} is not in "
                                   f"the kernel source")
            text = text.replace(old, new)
        cu = out / f"{name}.cu"
        cu.write_text(text)
        so = out / f"{name}.so"
        procs[name] = (so, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-shared", "-I",
             str(_build.CSRC), "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(str(so))
        for fn in ("line_tile_extinction", "layer_kmax"):
            getattr(lib, fn).argtypes = _build.SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("line_tile_ablation: needs a CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    libs = build_variants()
    hj = cs.TransitModel(cs.hotjupiter_config(), dtype=torch.float32,
                         device="cuda")
    args, kw = cs.file_state(hj)
    tab = kernel_lbl.layer_tables(hj.fdev, *args)
    load = _build.load_library
    times = {}
    try:
        for name in [*libs, *reversed(libs)]:
            _build.load_library = lambda lib=libs[name]: lib
            ms = cs.cuda_ms(lambda: kernel_lbl.line_tile_extinction(
                hj.fplan, hj.fdev, tab, args[0], **kw), runs=11)
            times.setdefault(name, []).append(ms)
            what = ABLATIONS[name][0] if name in ABLATIONS else "nothing"
            print(f"{name}: {ms:.4f} ms (leaves out {what})", flush=True)
    finally:
        _build.load_library = load
    print(json.dumps({"card": card, "ms": times}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
