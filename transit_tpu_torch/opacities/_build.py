"""Build and load the port's CUDA kernels.

The kernels are CUDA C++ with a plain C interface (``csrc/*.cu``), each
source compiled by its own ``nvcc`` (all started together), linked into
one shared library and loaded with ``ctypes`` — no PyTorch headers, so a
build takes seconds.  The library is built at first
use into ``build/transit_tpu_torch/`` beside the package, under a name
keyed by a hash of the sources and the flags, so an edited source is
rebuilt and an unchanged one is loaded as it is.

Not compiled with ``--use_fast_math``: the kernels' ``expf``/``cosf``
must stay accurate to ~1 ulp, or lines near the ethresh cut flip between
the kernel and its plain version.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG.parent / "build" / "transit_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# extern "C" entry points: name -> argument types (all return cudaError_t).
SIGNATURES = {
    "line_tile_extinction": [_P] * 15 + [_I] * 9 + [_F] * 5 + [_P],
    "line_tile_backward": [_P] * 2 + [_I] + [_P] * 9 + [_I] * 4 +
                          [_F] * 5 + [_P],
    "shell_tile_extinction": ([_P] * 15 + [_I] * 3 + [_P] + [_I] * 3 +
                              [_F] * 8 + [_P]),
    "shell_tile_backward": ([_P] * 15 + [_I] * 3 + [_P] + [_I] * 3 +
                            [_F] * 8 + [_P]),
    "layer_kmax": [_P] * 7 + [_I] * 3 + [_F] + [_P],
    "profile_scatter": [_P] * 13 + [_I] * 8 + [_P],
    "profile_scatter_backward": [_P] * 12 + [_I] * 7 + [_P],
}


def sources():
    """The kernel sources, in a fixed order."""
    return sorted(list(CSRC.glob("*.cu")) + list(CSRC.glob("*.cuh")))


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else /usr/local/cuda/bin/nvcc."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = ([os.path.join(home, "bin", "nvcc")] if home else []) + \
        [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                       "the CUDA toolkit's nvcc (set CUDA_HOME)")


def library_path() -> Path:
    """Where the library built from the current sources lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libtransit_kernels_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> tuple[Path, str]:
    """Compile the sources with nvcc unless the keyed library exists: one
    nvcc per ``.cu`` file, all at once, then one link.  Returns the
    library's path and the compilers' output ("" when the library was
    already built).  ``verbose`` always compiles, adds ``-Xptxas -v``
    (registers, shared memory and spills per kernel) and prints the
    compilers' output."""
    so = library_path()
    if so.exists() and not verbose:
        return so, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        jobs = []
        for src in (s for s in sources() if s.suffix == ".cu"):
            obj = os.path.join(tmpdir, src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
                   "-c", "-o", obj, str(src)]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        outs = [(cmd, obj, p.communicate()[0], p.returncode)
                for cmd, obj, p in jobs]
        for cmd, _, text, rc in outs:
            if rc != 0:
                raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}"
                                   f"\n{text}")
            if verbose:
                print(f"{' '.join(cmd)}\n{text}")
        tmp = os.path.join(tmpdir, "lib.so")
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", tmp,
               *(obj for _, obj, _, _ in outs)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                               f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
        os.replace(tmp, so)      # atomic: a reader never sees a partial .so
    return so, "\n".join(text for _, _, text, _ in outs)


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build if needed, load, and declare the entry points' C types."""
    lib = ctypes.CDLL(str(build()[0]))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
