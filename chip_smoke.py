"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile chiprun_out/forward_trace.json]

Builds the port's CUDA kernels (csrc/line_tile.cu: the line-tile kernel,
its backward and the per-layer kmax scan; csrc/shell_tile.cu: the
decimated far-wing shell kernel and its backward; csrc/profile_scatter.cu:
exact mode's profile scatter and its backward) from the sources in this
checkout, one nvcc per source,
and holds each against its plain PyTorch version on the card.  Then it
drives four paths of ``transit_tpu_torch.model.TransitModel(mode="fast",
use_kernel=True)`` and exact mode's (5. below), each through three
``forward`` requests with the kernels' launch counts set to 0 just
before and read just after:

  1. the unbanded plan on the hot-Jupiter workload (benchmarks/data/hj:
     100 layers, 19001 wavenumbers at 0.5 cm-1, 194,349 lines, eclipse);
  2. the main path, ``bands=6`` (the JAX package's benchmarked model),
     on the same workload: near tile classes and stride-1 far shells;
  3. ``bands=6`` on the same files at 0.05 cm-1 (190,001 wavenumbers),
     which adds decimated far-wing shells (strides 2 and 4);
  4. the transit path: the main path's model in transit geometry
     (toomuch 20) with hydrostatic radii (gsurf 2479 cm s-2, refpress
     1 bar, refradius 73760 km), so that every step rebuilds the radii,
     the path weights and the modulation table from T and q;
  5. exact mode, the default (the reference's profile-table scheme), on
     benchmarks/data/hj/hj_ref.cfg as the reference C binary ran it
     (0.5 cm-1 oversampled 2160 times, the 60 x 60 profile table).

It checks every launch of the banded paths against its plain version
(the shell kernel takes a band's decimated shells in one launch),
layer_kmax bit for bit at five temperature profiles on each path, the
spectra against the plain paths, the unbanded path and the reference C
spectrum, the launches per forward against the plan's, and the kernels'
work counters against host counts of the work; it times one ``forward``
and each kernel's launches of one forward (layer_kmax over many
launches), their plain versions, and their bounds (FP32, SFU and memory
terms).  With ``--profile`` it also traces forwards of the main path,
of the 0.05 cm-1 path, of the transit path and of the exact path with
torch.profiler (device time by kernel, busy share, device kernel count,
the port's kernels' shares), a gradient step of each, the transit
step's geometry alone, and the grid-interpolation path's forward and
gradient step.

The gradient (phases ``main_path_grad`` and ``fine_path_grad``): three
steps of ``torch.autograd.grad(forward(T, q).sum(), (T, q))`` on each
banded path, through the backward kernels ``line_tile_backward`` and
``shell_tile_backward``; each backward launch against its plain VJP on
the same inputs (per output, max|a-b| / max|b| < GRAD_LAUNCH_TOL), the
whole gradient against the plain path's, and against the plain path's
with the Voigt pair in float64 (GRAD_TOL), central differences
in T on two layers (FD_RTOL); times of a step and of each backward
kernel beside its bound (FP32, SFU and byte terms).  Phase
``main_path_batch``: ``forward_batch`` of BATCH perturbed profiles
against BATCH calls of ``forward``, and its gradient against theirs.
The transit phases (``transit_path*``) check the spectra against the
plain path, the ``modlevel=-1`` spectrum against its plain path, and the
card's float32 radii against float64 radpress on the CPU; time the
forward, the geometry and both forms of the modulation integral; run
the gradient and ``forward_batch`` checks above on the transit path
(central differences over the wavenumbers whose tau.last the step does
not move).  Phase ``hmc``: ``transit_tpu_torch.retrieval.hmc_sample``
over HMC_CHAINS chains through ``forward_batch`` on the transit path (an
8-knot log-temperature profile, 1% noise on the model's own spectrum);
it fails on a non-finite sample or an acceptance of 0.
The exact phases (``exact_*``) build the profile table on the card
(and on the CPU, within 1 float32 ulp of it), hold ``profile_scatter``
and ``profile_scatter_backward`` against their plain versions at the
file's T and +-50 K and on a synthetic case whose wide tiles take the
kernels' global-memory path (pair counters against host counts, the
backward bit for bit), check the
spectra against the plain path and the reference C spectrum (median
|flux/C - 1| < EXACT_C_MEDIAN_TOL), time the forward and both kernels
beside their bounds, and run three gradient steps (against the plain
path's, central differences at a step that moves no profile index and
no keep flag).
The grid phases (``grid_*``, ``cli_mode_b``) build the opacity grid of
hj_ref.cfg at bench.py's 25 temperatures (100 x 25 x 4 x 19001) through
the exact builder (``profile_scatter`` with per-molecule rows; every
chunk's launch against its plain version, its pair counter against the
host count) and the fast builder (``layer_kmax`` bit for bit and a few
cells of each band's ``line_tile_extinction`` launches against their
plain versions, at unit density), each with its launches counted from
0; hold the exact grid's rows times the densities against the exact
model's line extinction (ethresh 1e-30); write the grid and run the
grid-interpolation path from the file (three forwards that launch no
line kernel, ``compute``, ``grid_extinction`` against float64 on the
CPU, the gradient against the float64 model's; grid mode against the
exact model's line-by-line where the interpolation in T is exact and
half-way between two grid temperatures: the extinction of an
isothermal profile on a node within GRID_CONSISTENCY_TOL of its max);
and run the CLI's
opacity modes (b) and (c) on the fixture on the card.
The sharded and multi-process phases: ``sharded_main`` and
``sharded_fine`` run the main path's and the 0.05 cm-1 path's models in
SHARDS line-balanced wavenumber shards (parallel.sharded, one process:
each shard through ``step.local``, then ``step.assemble``), every
shard's launches (``layer_kmax`` bit for bit, the line-tile and shell
launches and both backward kernels) against their plain versions, the
assembled spectrum against the unsharded ``forward``
(BANDED_VS_UNBANDED_TOL) and its gradient against the unsharded one
(GRAD_TOL), the launch counts of one sharded step against the shards'
plans, load max/min and a shard's step time beside the unsharded
forward's, then the compiled step (``make_sharded_forward`` on the
card: one CUDA graph of the 4 shards and the assembly) against the
eager one as the graphed phases below do; ``sharded_collective`` runs
the compiled collective step over a world-size-1 NCCL group (bit for bit
the eager local assembly, forward and gradient, both timed; scaling over
cards is not measured: one card); ``multihost_card`` spawns MH_PROCS
processes on the one card joined by a gloo group
(parallel.multihost.MultihostForward: balanced bounds, a band-local read
of hj.tli, the global kmax through ``layer_kmax``, the band step and the
band kmax as CUDA graph replays) and holds the gathered spectrum and
``value_and_grad`` against the single process and against the eager
band step (``eager_band``), both timed; ``multihost_grid`` runs grid-mode band models from the grid
file of ``grid_path`` against the full grid model.  A failed worker, a
missing NCCL backend or a refused group fails the run.
The graphed phases (``graph_unbanded``, ``graph_main``,
``graph_main_batch``, ``graph_fine``, ``graph_transit``, ``graph_exact``,
``graph_grid``) run each path's model
through ``TransitModel.make_forward()``, the step as CUDA graph replays
(the forward captured with its backward): three requests against the
eager ``forward`` (``forward_batch`` with BATCH members in
``graph_main_batch``), spectra bit for bit (the exact path, whose
float32 atomics differ from call to call, and the grid path: within
GRAPH_TOL),
gradients within GRAPH_TOL, request 1's results unchanged by the later
requests; the graphed and eager forward and gradient step timed side by
side, the device time and kernels of one replay and of one eager step
from torch.profiler (a replay moves no launch counter) and the memory
the captures reserve; ``graph_main`` also checks that
a ``make_forward()`` made after ``set_cloudtop`` equals the eager
forward with the new deck.  ``hmc`` times a leapfrog evaluation through
the graphed batched step beside the eager one.
Every phase prints one line with its seconds; any failed check raises,
so the script exits non-zero and prints no result.

Output, last three lines: the card's name and power limit as nvidia-smi
gives them precedes them; then one ``{"kernels": [...]}`` JSON object and,
last, ``{"ok": true, "device": {...}}``.  Without a CUDA device it exits
with code 1 at once.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import datetime
import gc
import json
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from transit_tpu_torch import cli
from transit_tpu_torch.config import TransitConfig, load_config
from transit_tpu_torch.constants import SUNRADIUS
from transit_tpu_torch.grids import make_wn_sampling
from transit_tpu_torch.model import TransitModel
from transit_tpu_torch.opacities import _build, banded, grid, kernel_lbl
from transit_tpu_torch.opacities.kernel_profile import (
    profile_scatter, profile_scatter_backward, profile_scatter_permol)
from transit_tpu_torch.opacities.lbl import (
    SCATTER_SEGMENT, ScatterTables, layer_groups, profile_scatter_plain,
    profile_scatter_plain_vjp, scatter_geometry, scatter_pairs,
    scatter_tables, scatter_tiles, tile_spans)
from transit_tpu_torch.opacities.kernel_lbl import (
    acc_grads, kernel_extinction, layer_kmax, layer_tables, line_tile_backward,
    line_tile_extinction, plain_extinction, plain_kmax, plain_line_tiles,
    plain_line_tiles_vjp, run_counts, strength_coef, tile_cotangent,
    work_counts, zero_grads)
from transit_tpu_torch.opacities.kernel_shell import (
    plain_shell_band, plain_shell_vjp, shell_counts, shell_tile_backward,
    shell_tile_extinction)
from transit_tpu_torch.opacities.voigt import build_profile_table
from transit_tpu_torch.parallel import multihost
from transit_tpu_torch.parallel.sharded import (GraphedShardedStep,
                                                 ShardedStep,
                                                 make_sharded_forward)
from transit_tpu_torch.retrieval import (batched_value_and_grad,
                                         gaussian_logprob, hmc_sample,
                                         knot_profile)
from transit_tpu_torch.rt.geometry import radpress_torch
from transit_tpu_torch.rt.transmission import modulation

from exact_profile import PORT_KERNELS, profile_step

ROOT = Path(__file__).resolve().parent
FIX = ROOT / "tests" / "fixtures"
HJ = ROOT / "benchmarks" / "data" / "hj"
HJ_SHAPE = (19001, 100)        # wavenumbers, layers
HJ_FINE_SHAPE = (190001, 100)  # at 0.05 cm-1

# Kernel against its plain version: max |a-b| / (|a| + 1e-6 max|a|), the
# bound of the JAX package's Pallas-vs-XLA test (tests/test_pallas.py:35).
KERNEL_REL_TOL = 1e-5
# Spectra of the kernel path against the plain path (float32 sums in
# another order: ~1e-6 expected).
SPECTRUM_REL_TOL = 1e-4
# The banded main path's spectrum against the unbanded kernel path's:
# the same physics (far shells take the region-II branch the w4 kernel
# would), in float32 with the bin wavenumbers rounded in another order
# (fast._run_tiles' against the Pallas kernel's).
BANDED_VS_UNBANDED_TOL = 1e-5
# Median |flux/C - 1| against the reference C spectrum (the JAX fast mode
# recorded 0.23% on these files, benchmarks/RESULTS.md:253).
C_MEDIAN_TOL = 1e-2
RUNS = 5

# H100 SXM peaks at the full 700 W power limit (NVIDIA data sheet): FP32
# outside the tensor cores, and HBM3 bandwidth.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# The special-function unit (MUFU: exp2, reciprocal, ...): 16 results a
# clock on each of the 132 SMs, at the 1.98 GHz clock of PEAK_FP32
# (132 x 128 FP32 lanes x 2 x 1.98e9 = 67e12): a quarter of the FP32 rate.
PEAK_MUFU = 132 * 16 * 1.98e9
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
# The far-wing kernels (csrc/voigt.cuh): region II alone with its floor,
# and the two-term asymptotic pair.
OPS_WFN = {"r2": 44, "asym2": 20}
# Per (tile, line) of a decimated shell, its halo weight (distance to the
# tile, the smoothstep: 12); per output of a decimated shell, the
# Catmull-Rom weights' products and sums, the clip and the add (9).
OPS_WEIGHT = 12
OPS_UPSAMPLE = 9
# Operations of the kmax scan per (layer, line): the strength chain k0
# (2 multiplies and 2 divides into the exps, 2 exps, a subtract, 3
# multiplies) and the max.
OPS_KMAX = 12
# MUFU operations the functions need besides (each also counted once
# above): per strength chain its two exps (the divisions are by the
# layer's T, a per-layer constant: FP32 work once its reciprocal is
# hoisted); per (layer, line) of a line-tile or shell function the two
# exps and 1/alphaD; per Voigt evaluation the rational's reciprocals (w4:
# region II two, III one, IV one and an exp; r2 two; asym2 one).
MUFU_KMAX = 2
MUFU_LAYER_LINE = 3
MUFU_REGION = {"II": 2, "III": 1, "IV": 2}
MUFU_WFN = {"r2": 2, "asym2": 1}
# The backward function (fast._block_val_bwd, which computes in the
# forward's dtype: float32 here): per (layer, line) the forward's chain
# (OPS_LAYER_LINE) and the chain to the cotangents (gk, g_invaD, the
# strength and temperature terms, the four tables: 26); per (bin or point,
# line) pair the distance and x (4), the pair w = (Re, Im) (the region's
# or function's count and the Im part: 6 more), the two Faddeeva partials
# (9) and the three sums (11); per output bin of a decimated shell the
# transposed upsampling (8).  MUFU: the chain's two exps and 1/alphaD;
# each divide's reciprocal.  The bound counts all of it at the FP32 rate.
# The kernels run the sums' three adds per pair and the chain in FP64 (a
# design choice, not the function's; the pair is float32):
# "fp64_design" beside the bound is the time of those operations at the
# FP64 rate.
OPS_BWD_CHAIN = 26
OPS_BWD_PAIR32 = 4
OPS_BWD_PAIR64 = 26
OPS_BWD_SUM64 = 3
OPS_BWD_UPSAMPLE = 8
MUFU_BWD_REGION = {"II": 2, "III": 1, "IV": 1}
# H100 SXM FP64 outside the tensor cores at the 700 W limit (NVIDIA data
# sheet): half the FP32 rate.
PEAK_FP64 = 34e12
# Bounds of the gradient phases: each backward launch against its plain
# VJP on the same inputs, per output max|a-b| / max|b|; the whole
# gradient of the kernel path against the plain path's (plain VJPs);
# central differences in T (two layers, step FD_STEP K) against the
# gradient, float32, of the spectrum summed over the wavenumbers whose
# tau.last does not move at T +- step (a difference across a jump of
# last is not a derivative; their count is printed); on the transit
# path the differences are the float64 plain model's, at FD_STEP_64 (the
# float32 forward stores radii of ~7e4 km in steps of 0.008 km, and its
# 5 K differences missed the gradient by 5%; the float64 model's 0.5 K
# differences still missed by 2.5%, where bins cross a line's wing
# cutoff, as grad_fd_study.py shows for eclipse; at 0.05 K few do);
# forward_batch against a loop of forward, and its gradient against the
# loop's.
GRAD_LAUNCH_TOL = 1e-4
GRAD_TOL = 1e-3
FD_RTOL = 2e-2
FD_STEP = 5.0
FD_STEP_64 = 0.05
BATCH = 8
BATCH_TOL = 1e-6
BATCH_GRAD_TOL = 1e-4
# The transit path (bench.py:167-199's transit workload on the
# hot-Jupiter files: toomuch 20, the modulation1 endpoint) with
# hydrostatic radii: gsurf in cm s-2, refpress and refradius in the
# atmosphere file's units (bar, km: hj.atm's 1-bar layer).  The card's
# float32 radii against float64 radpress_torch on the CPU: max
# |a - b| / |b| < RADII_TOL (float32 rounding over 99 steps of the
# recurrence, ~1e-6); the two forms of the modulation integral against
# each other < SPECTRUM_REL_TOL.
TRANSIT_TOOMUCH = 20.0
HYDRO = {"gsurf": 2479.0, "refpress": 1.0, "refradius": 73760.0}
RADII_TOL = 1e-5
# The HMC phase (benchmarks/retrieval_demo.py:hmc_demo on the transit
# path): chains through forward_batch, an 8-knot log-temperature
# profile, 1% noise on the model's own spectrum, leapfrog steps of
# HMC_STEP in log T.
# The graphed step (phases graph_*, TransitModel.make_forward): its
# spectra against the eager forward's bit for bit, except on the exact
# path, whose co-add sums add in float32 atomics (index_add) in an order
# that changes from call to call, and on the grid path, held to the same
# bound (its spectra came out bit for bit so far): max |a - b| / max |b|
# <= GRAPH_TOL; the gradients within GRAPH_TOL (the backward kernels add
# in float64 atomics, cast once).  The cloud deck of the main path's settings check:
# log10 bar of its top before and after set_cloudtop.
GRAPH_TOL = 1e-6
GRAPH_CLOUDTOP = (-2.0, -4.0)
HMC_CHAINS = 16
HMC_KNOTS = 8
HMC_LEAPFROG = 8
HMC_SAMPLES = 4
HMC_STEP = 1e-4
# Exact mode (phases exact_*, on hj_ref.cfg): the median of |flux/C - 1|
# against the reference C spectrum, which the C code computed in this
# mode with this table (the gap should be float32 rounding; the CPU
# port's float32 spectrum is 1.9e-7 from it); central differences in T
# of the float64 plain model at the largest step from EXACT_FD_STEP down,
# halving, that moves no profile index and no keep flag (at least
# EXACT_FD_MIN K), on the first two of the EXACT_FD_LAYERS layers of
# largest |dF/dT| that have such a step (a group can sit on an index's
# jump: hj.atm's layer 31 moves a Doppler index at +1e-5 K).
EXACT_C_MEDIAN_TOL = 1e-4
EXACT_FD_STEP = 0.05
EXACT_FD_MIN = 1e-5
EXACT_FD_LAYERS = 8
# The synthetic profile-scatter case (synthetic_scatter): layers, groups
# (three isotope runs; not a multiple of the 256-group tile), coarse bins.
SYN_SHAPE = (8, 700, 5000)
# The opacity grid of hj_ref.cfg: bench.py:316's temperatures (tlow,
# thigh, tempdelt) and the grid's (layers, temperatures, molecules,
# wavenumbers).  Two exact builds differ by the float32 atomics' order
# of sums (GRID_BUILDS_TOL of the max); the grid's rows of a cell times
# its densities against the exact model's line extinction of that cell
# as a layer, at ethresh 1e-30 (tests/test_opacity_grid.py:78: the grid
# cuts at each molecule's kmax, the spectrum at the kmax of all), within
# GRID_CONSISTENCY_TOL of the max, on the GRID_LAYERS at every grid
# temperature.
GRID_T = (500.0, 2900.0, 100.0)
GRID_SHAPE = (100, 25, 4, 19001)
GRID_BUILDS_TOL = 1e-6
GRID_CONSISTENCY_TOL = 1e-5
GRID_LAYERS = (0, 50, 99)
# The grid temperature (index into GRID_T's nodes, 1300 K) of the
# isothermal grid-vs-lbl comparison, inside the file atmosphere's
# 1150-1534 K.
GRID_ISO_NODE = 8
# Lines of each band of the fast build compared with their plain
# version: the band's first, middle and last cell.
GRID_FAST_CELLS = 3
# The sharded phases: a banded path in SHARDS line-balanced wavenumber
# shards on the one card, each through step.local, assembled.  The
# multi-process phases: MH_PROCS processes (bands) on the one card,
# joined by a gloo group; a process waits MH_TIMEOUT s for the others.
SHARDS = 4
MH_PROCS = 2
MH_TIMEOUT = 300


class CheckFailed(RuntimeError):
    pass


def check(cond, msg: str):
    if not cond:
        raise CheckFailed(msg)


def ptxas_summary(log: str) -> dict:
    """{kernel: "N registers, S bytes stack"} of the backward kernels,
    from nvcc's -Xptxas -v output (one entry function after another)."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([\w$]+)", line)
        if m:
            name = next((k for k in ("line_tile_bwd_kernel",
                                     "shell_tile_bwd_kernel")
                         if k in m.group(1)), None)
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame", line)
        if m:
            out.setdefault(name, {})["stack_bytes"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.setdefault(name, {})["registers"] = int(m.group(1))
    return out


def phase(name: str, t0: float, text: str = ""):
    print(f"phase {name}: {time.perf_counter() - t0:.2f} s {text}".rstrip(),
          flush=True)


def nbytes_of(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def fixture_config() -> TransitConfig:
    """The repo's conformance fixture (tests/fixtures: 20 layers, 101
    wavenumbers, eclipse)."""
    return TransitConfig(
        atm=f"{FIX}/test.atm", linedb=f"{FIX}/test.tli",
        csfile=f"{FIX}/test_cia.dat", molfile=f"{FIX}/molecules.dat",
        wnlow=2000.0, wnhigh=2100.0, wndelt=1.0, wnosamp=216, wnfct=1.0,
        nwidth=20.0, ethreshold=1e-8, solution="eclipse", toomuch=1e30)


def hotjupiter_config(wndelt: float = 0.5) -> TransitConfig:
    """The hot-Jupiter workload (bench.py:208-240, hj_ref.cfg); at
    0.05 cm-1 the oversampling factor is cut from 2160 to 2: fast mode
    never reads the oversampled grid, whose 4e8 points would only take
    host memory."""
    return TransitConfig(
        atm=f"{HJ}/hj.atm", linedb=f"{HJ}/hj.tli",
        csfile=f"{HJ}/cia_H2_H2.dat,{HJ}/cia_H2_He.dat",
        molfile=f"{HJ}/molecules.dat", wnlow=500.0, wnhigh=10000.0,
        wndelt=wndelt, wnosamp=2160 if wndelt >= 0.5 else 2, wnfct=1.0,
        nwidth=20.0, ethreshold=1e-8, solution="eclipse", toomuch=1e30)


def transit_config() -> TransitConfig:
    """The hot-Jupiter workload at 0.5 cm-1 in transit geometry
    (toomuch 20, as bench.py:167-199's transit workload) with
    hydrostatic radii (HYDRO); starrad at its default."""
    cfg = hotjupiter_config()
    cfg.solution = "transit"
    cfg.toomuch = TRANSIT_TOOMUCH
    for k, v in HYDRO.items():
        setattr(cfg, k, v)
    return cfg


def file_state(m: TransitModel, temps_raw=None):
    """Line-extinction arguments for the model's file atmosphere, or for
    its densities at the temperatures ``temps_raw``."""
    if temps_raw is None:
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


def kmax_profiles(m: TransitModel) -> dict:
    """The temperature profiles on which layer_kmax is held to its plain
    version: the file's, 50 K above and below it, and isothermal 300 K
    and 3000 K."""
    T = m._t(m.atm.temp)
    return {"file": T, "+50K": T + 50.0, "-50K": T - 50.0,
            "300K": torch.full_like(T, 300.0),
            "3000K": torch.full_like(T, 3000.0)}


def kmax_vs_plain(m: TransitModel, label: str, view=None) -> float:
    """layer_kmax against plain_kmax on the same inputs, on the card, as
    the model's forward calls it: on the unbanded arrays with jnp.max's
    floor -inf, or, on a banded model, on the banded arrays (of the shard
    ``view`` (banded plan, tensors, index) when given) with the
    coefficient of prep_layers and floor 0; at each profile of
    kmax_profiles.  They must agree bit for bit (a max does not depend on
    order, and both round each operation the same way).  Returns max
    |a - b| over the profiles."""
    worst = 0.0
    for name, temps_raw in kmax_profiles(m).items():
        args, _ = file_state(m, temps_raw)
        if m.bplan is None:
            d, floor = m.fdev, -torch.inf
            coef0 = strength_coef(d, args[2])
        else:
            d, floor = (m.bdev if view is None else view[1])[0], 0.0
            coef0 = banded.prep_layers(d, *args, use_kernel=False)["coef0"]
        a = plain_kmax(d, args[0], coef0, floor=floor)
        b = layer_kmax(d, args[0], coef0, floor=floor)
        torch.cuda.synchronize()
        check(a.shape == b.shape == (m.atm.nlayers,) and
              bool(torch.isfinite(a).all()),
              f"{label} {name}: kmax shapes {tuple(a.shape)} "
              f"{tuple(b.shape)}")
        if not torch.equal(a, b):
            i = int((a != b).nonzero()[0])
            raise CheckFailed(f"{label} {name}: layer_kmax differs from "
                              f"plain kmax at layer {i}: {float(a[i])!r} "
                              f"{float(b[i])!r}")
        worst = max(worst, float((a - b).abs().max()))
    return worst


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


def graph_ms(fn, n: int = 200, runs: int = RUNS) -> float:
    """Time of one fn() over many back-to-back launches: fn() n times
    captured in a CUDA graph, the graph replayed runs times after a
    warm-up, CUDA events around each replay; median / n.  Reads the
    device's time of fn, not the host's launch rate."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(n):
            fn()
    g.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        g.replay()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / n)
    return statistics.median(times)


def roofline(ops: float, nbytes: float, mufu: float = 0.0) -> tuple:
    """(bound_ms, bound_by, unit): the largest of the FP32 operation, MUFU
    operation and byte times at the card's peaks; bound_by "operations"
    (unit "fp32" or "mufu") or "bytes"."""
    terms = {"fp32": ops / PEAK_FP32, "mufu": mufu / PEAK_MUFU,
             "bytes": nbytes / PEAK_BYTES}
    unit = max(terms, key=terms.get)
    return (1e3 * terms[unit], "bytes" if unit == "bytes" else "operations",
            unit)


def kmax_bound(d, nl: int) -> tuple:
    """(bound_ms, bound_by, unit, ops, bytes) of the kmax scan of nl
    layers over the line list of d."""
    chains = nl * d["all_wavn"].shape[0]
    nbytes = nbytes_of(d["all_wavn"], d["all_elow"], d["all_gf"],
                       d["all_iso"]) + 4 * nl * (2 + d["iso_mass"].shape[0])
    return (*roofline(OPS_KMAX * chains, nbytes, MUFU_KMAX * chains),
            OPS_KMAX * chains, nbytes)


def bound(m: TransitModel, tab, counts) -> tuple:
    """(bound_ms, bound_by, unit, ops, bytes) of the line-tile
    function."""
    ops = (OPS_LAYER_LINE * counts["layer_lines"] +
           sum((OPS_EVAL + OPS_REGION[r]) * counts[r] for r in OPS_REGION))
    mufu = (MUFU_LAYER_LINE * counts["layer_lines"] +
            sum(MUFU_REGION[r] * counts[r] for r in OPS_REGION))
    d = m.fdev
    nbytes = sum(d[k].numel() * d[k].element_size()
                 for k in ("wavn", "elow", "gf", "iso", "mask"))
    nbytes += sum(t.numel() * t.element_size() for t in tab.values())
    nbytes += 4 * m.atm.nlayers * (1 + m.wns.n)       # temps in, output
    return (*roofline(ops, nbytes, mufu), ops, nbytes)


def distinct_lines(*plans) -> int:
    """Lines of the sorted list that the plans' tiles hold, each counted
    once (a line sits in several tiles' ranges, and in several plans of a
    band)."""
    n = plans[0].wavn.shape[0]
    mark = np.zeros(n + 1, dtype=np.int64)
    for plan in plans:
        c1 = (plan.tile_count if plan.tile_count1 is None else
              plan.tile_count1)
        ranges = [(plan.tile_start, plan.tile_start + c1)]
        if plan.tile_start2 is not None:
            ranges.append((plan.tile_start2,
                           plan.tile_start2 + plan.tile_count - c1))
        for s, e in ranges:
            np.add.at(mark, s, 1)
            np.add.at(mark, e, -1)
    return int((np.cumsum(mark[:n]) > 0).sum())


def rel_err(a, b) -> float:
    """max |a-b| / (|a| + 1e-6 max|a|), a the plain version; an all-zero
    reference must be matched exactly."""
    if not bool(a.any()):
        return 0.0 if not bool(b.any()) else float("inf")
    return float(((a - b).abs() / (a.abs() + 1e-6 * a.abs().max())).max())


def model_view(m: TransitModel, view=None):
    """(banded plan, tensors, kernel index): the model's own, or a
    shard's ``view`` (parallel.sharded's ShardedStep._view)."""
    return (m.bplan, m.bdev, m.bindex) if view is None else view


def banded_launches(m: TransitModel, view=None):
    """The kernel launches of one banded forward (of the shard ``view``
    when given), in order: yields
    (part, unit, the band's rows as an int32 and a long tensor) with part
    "near" or "s1" (line-tile kernel, unit (plan, line tensors, global
    tiles (numpy or None), their int32 tensor)) or "shell" (one shell
    launch for the band's decimated shells, unit its ShellBand)."""
    bplan, devs, index = model_view(m, view)
    for i, part, unit in banded.launch_units(bplan, devs, index):
        r = index["rows"][i]
        yield part, unit, r, r.long()


def launch_kernel(tab, T, kw, part, unit, r, out, stats=None):
    """One launch of the banded path into ``out``."""
    if part == "shell":
        shell_tile_extinction(unit, tab, T, rows=r, out=out, stats=stats,
                              **kw)
    else:
        plan, dc, _, t = unit
        line_tile_extinction(plan, dc, tab, T, tiles=t, rows=r, out=out,
                             accumulate=part == "s1", bins_first=True,
                             stats=stats, **kw)


def launch_plain(tab, T, kw, part, unit, sel, out):
    """The plain version of one launch, into ``out``."""
    if part == "shell":
        plain_shell_band(unit, tab, T, rows=sel, out=out, **kw)
        return
    plan, dc, gidx, _ = unit
    val = plain_line_tiles(plan, dc, {k: v[sel] for k, v in tab.items()},
                           T[sel], gidx=gidx, bins_first=True, **kw)
    g = (torch.arange(plan.ntiles, device=T.device) if gidx is None else
         torch.as_tensor(gidx, device=T.device).long())
    cols = (g[:, None] * plan.tw +
            torch.arange(plan.tw, device=T.device)).flatten()
    keep = cols < out.shape[1]
    r, c = sel[:, None], cols[keep][None, :]
    v = val.reshape(sel.shape[0], -1)[:, keep]
    out[r, c] = out[r, c] + v if part == "s1" else v


def kernel_name(part: str) -> str:
    return ("shell_tile_extinction" if part == "shell" else
            "line_tile_extinction")


def banded_vs_plain(m: TransitModel, label: str, view=None) -> dict:
    """Every launch of the banded path (of the shard ``view`` when given)
    on its own, into a zero output, against its plain version on the same
    inputs (the band's rows): {kernel: {"max_rel", "max_abs",
    "launches"}}."""
    args, kw = file_state(m)
    T = args[0]
    tab = banded.prep_layers(model_view(m, view)[1][0], *args,
                             use_kernel=True)
    res = {}
    for part, unit, r, sel in banded_launches(m, view):
        got = torch.zeros((m.atm.nlayers, m.wns.n), device=T.device)
        want = torch.zeros_like(got)
        launch_kernel(tab, T, kw, part, unit, r, got)
        launch_plain(tab, T, kw, part, unit, sel, want)
        got, want = got[sel], want[sel]
        check(bool(torch.isfinite(got).all()),
              f"{label} {part}: kernel output not finite")
        err = rel_err(want, got)
        desc = (f"strides {[s for *_, s in unit.parts]}" if part == "shell"
                else f"tw {unit[0].tw}, {unit[0].wfn_tag}, lmax "
                f"{unit[1]['wavn'].shape[1]}")
        check(err < KERNEL_REL_TOL,
              f"{label} {part} ({desc}): kernel vs plain {err:.3e} >= "
              f"{KERNEL_REL_TOL}")
        e = res.setdefault(kernel_name(part), {"max_rel": 0.0,
                                               "max_abs": 0.0,
                                               "launches": 0})
        e["max_rel"] = max(e["max_rel"], err)
        e["max_abs"] = max(e["max_abs"], float((got - want).abs().max()))
        e["launches"] += 1
    return res


def run_requests(m: TransitModel, requests, kernels) -> tuple:
    """Three forward requests with the launch counts set to 0 just before
    and read just after: (spectra, {kernel: launches})."""
    for k in kernels:
        k.launches = 0
    specs = [m.forward(T, q) for T, q in requests]
    torch.cuda.synchronize()
    return specs, {k.__name__: k.launches for k in kernels}


def per_forward(launches: dict) -> dict:
    return {k: v / 3 for k, v in launches.items()}


def check_launches(m: TransitModel, launches: dict, label: str):
    """Three forwards of a banded model launched each kernel as often as
    its plan asks: layer_kmax once, the line-tile kernel once per near or
    stride-1 class, the shell kernel once per band with decimated
    shells."""
    want = {"layer_kmax": 1, "line_tile_extinction": 0,
            "shell_tile_extinction": 0}
    for _, part, _ in banded.launch_units(m.bplan, m.bdev, m.bindex):
        want[kernel_name(part)] += 1
    got = per_forward(launches)
    check(got == want, f"{label}: launches per forward {got}, the plan "
          f"asks {want}")


def check_spectra(m: TransitModel, specs, requests, label: str) -> float:
    """Finite positive spectra of the right shape, and the kernel path
    against the plain path; returns the max relative difference."""
    for s in specs:
        check(s.shape == (m.wns.n,) and s.dtype == torch.float32,
              f"{label}: spectrum {tuple(s.shape)} {s.dtype}")
        check(bool(torch.isfinite(s).all()) and float(s.min()) > 0,
              f"{label}: spectrum not finite and positive")
    m.use_kernel = False
    plain = [m.forward(T, q) for T, q in requests]
    m.use_kernel = True
    err = max(float(((a - b).abs() / b.abs()).max())
              for a, b in zip(specs, plain))
    check(err <= SPECTRUM_REL_TOL,
          f"{label}: kernel path vs plain path {err:.3e} > "
          f"{SPECTRUM_REL_TOL}")
    return err


def c_median(m: TransitModel, spec, with_max: bool = False) -> tuple:
    """Median and 90th percentile (and with ``with_max`` the max) of
    |flux/C - 1| against the reference C spectrum (listed from 20 um
    down: ascending wavenumber)."""
    ref = np.loadtxt(HJ / "hj_ref_spectrum.dat")
    wl = 1e4 / m.wns.v
    check(ref.shape == (m.wns.n, 2) and
          np.allclose(ref[:, 0], wl, rtol=1e-6),
          "reference C spectrum is on another grid")
    rel = np.abs(spec.double().cpu().numpy() / ref[:, 1] - 1.0)
    out = (float(np.median(rel)), float(np.quantile(rel, 0.9)))
    return out + (float(rel.max()),) if with_max else out


def banded_times(m: TransitModel) -> dict:
    """Per kernel of the banded path: the time of its launches of one
    forward (CUDA events, median of RUNS; layer_kmax over many launches),
    of their plain versions, the bound of the work they need, the
    counters from one forward against the host counts of the same
    work."""
    args, kw = file_state(m)
    T = args[0]
    nl = m.atm.nlayers
    tab = banded.prep_layers(m.bdev[0], *args, use_kernel=True)
    launches = list(banded_launches(m))
    out = torch.zeros((nl, m.wns.n), device=T.device)
    res = {}
    for name in ("line_tile_extinction", "shell_tile_extinction"):
        mine = [x for x in launches if kernel_name(x[0]) == name]
        if not mine:
            continue
        ms = cuda_ms(lambda: [launch_kernel(tab, T, kw, p, u, r, out)
                              for p, u, r, _ in mine])
        plain_ms = cuda_ms(lambda: [launch_plain(tab, T, kw, p, u, sel, out)
                                    for p, u, _, sel in mine], runs=1)
        res[name] = {"ms": ms, "plain_ms": plain_ms, "launches": len(mine)}
    # kmax: the scan of prep_layers (floor 0), over many launches.
    coef0 = tab["coef0"]
    res["layer_kmax"] = {
        "ms": graph_ms(lambda: layer_kmax(m.bdev[0], T, coef0, floor=0.0)),
        "ms_events": cuda_ms(lambda: layer_kmax(m.bdev[0], T, coef0,
                                                floor=0.0)),
        "plain_ms": cuda_ms(lambda: plain_kmax(m.bdev[0], T, coef0,
                                               floor=0.0)),
        "launches": 1}
    # Counters of one forward's launches against the host count.
    stats = {k: torch.zeros(3, dtype=torch.int64, device=T.device)
             for k in ("line_tile", "shell")}
    banded.banded_kernel_extinction(m.bplan, m.bdev, *args, index=m.bindex,
                                    stats=stats, **kw)
    host = banded.banded_counts(m.bplan, m.bdev, tab, T, **kw)
    card = {"line_tile": dict(zip(("chains", "live", "pairs"),
                                  stats["line_tile"].tolist())),
            "shell": dict(zip(("chains", "live", "evals"),
                              stats["shell"].tolist()))}
    check(card == host, f"banded kernel counters {card} != host {host}")
    # Bounds: the work each function needs on these inputs, as [FP32
    # operations, bytes, MUFU operations].
    tables = nbytes_of(*(tab[k] for k in ("alphal", "alphad_f", "coef0",
                                          "densm", "kmax")), T)
    need = {"line_tile_extinction": [0, tables, 0],
            "shell_tile_extinction": [0, tables, 0]}
    for i, (a, b) in enumerate(m.bplan.slices):
        nrows = b - a
        parts = [(p, pl) for bi, _, p, pl, _, _ in
                 banded.band_parts(m.bplan, m.bdev) if bi == i]
        lt = [pl for p, pl in parts if p != "shell"]
        sh = [pl for p, pl in parts if p == "shell"]
        for key, plans in (("line_tile_extinction", lt),
                           ("shell_tile_extinction", sh)):
            if plans:
                chains = nrows * distinct_lines(*plans)
                need[key][0] += OPS_LAYER_LINE * chains
                need[key][2] += MUFU_LAYER_LINE * chains
    for part, unit, r, sel in launches:
        key = kernel_name(part)
        if part == "shell":
            tw = unit.parts[0][0].tw
            tiles = unit.blocks[:, 0].cpu().numpy().astype(np.int64)
            ncol = int(np.minimum(m.wns.n - tiles * tw, tw).sum())
            need[key][1] += (nbytes_of(*unit.lines.values(), unit.blocks) +
                             4 * sel.shape[0] * ncol * 2)
            need[key][0] += (OPS_WEIGHT * unit.lines["wavn"].shape[0] +
                             OPS_UPSAMPLE * sel.shape[0] * ncol *
                             len(unit.parts))
            tab_r = {k: v[sel] for k, v in tab.items()}
            for plan, classes, stride in unit.parts:
                for dc, gidx in classes:
                    c = shell_counts(plan, dc, tab_r, T[sel], stride=stride,
                                     gidx=gidx, **kw)
                    need[key][0] += c["evals"] * (OPS_EVAL +
                                                  OPS_WFN[plan.wfn_tag])
                    need[key][2] += c["evals"] * MUFU_WFN[plan.wfn_tag]
            continue
        plan, dc, gidx, _ = unit
        ncol = min(m.wns.n, plan.ntiles * plan.tw) if gidx is None else \
            int(np.minimum(m.wns.n - np.asarray(gidx) * plan.tw,
                           plan.tw).sum())
        need[key][1] += (nbytes_of(*(dc[k] for k in ("wavn", "elow", "gf",
                                                     "iso", "mask"))) +
                         4 * sel.shape[0] * ncol * (1 if part == "near"
                                                    else 2))
        tab_r = {k: v[sel] for k, v in tab.items()}
        w = work_counts(plan, {**dc, "all_wavn": m.bdev[0]["all_wavn"]},
                        tab_r, T[sel], gidx=gidx, bins_first=True, **kw)
        if plan.wfn_tag == "w4":
            need[key][0] += sum((OPS_EVAL + OPS_REGION[g]) * w[g]
                                for g in OPS_REGION)
            need[key][2] += sum(MUFU_REGION[g] * w[g] for g in OPS_REGION)
        else:
            ev = sum(w[g] for g in OPS_REGION)
            need[key][0] += (OPS_EVAL + OPS_WFN[plan.wfn_tag]) * ev
            need[key][2] += MUFU_WFN[plan.wfn_tag] * ev
    for name, (ops, nb, mufu) in need.items():
        if name in res:
            b_ms, b_by, unit = roofline(ops, nb, mufu)
            res[name].update(bound_ms=b_ms, bound_by=b_by, bound_unit=unit,
                             ops=ops, mufu=mufu, bytes=nb)
    b_ms, b_by, unit, km_ops, km_bytes = kmax_bound(m.bdev[0], nl)
    res["layer_kmax"].update(bound_ms=b_ms, bound_by=b_by, bound_unit=unit,
                             ops=km_ops, mufu=MUFU_KMAX * nl *
                             m.bdev[0]["all_wavn"].shape[0], bytes=km_bytes)
    res["counters"] = card
    return res


def plan_summary(m: TransitModel) -> str:
    """Bands, tile widths, classes and shells of a banded plan."""
    out = []
    for i, ((a, b), p) in enumerate(zip(m.bplan.slices, m.bplan.plans)):
        far = m.bplan.far_plans[i] if m.bplan.far_plans else None
        shells = ",".join(f"s{s}:{fp.wfn_tag}:{fp.lanes}"
                          f":{fp.class_lmax or fp.lmax}"
                          for fp, _, s in far or [])
        out.append(f"band {i} layers {b - a} tw {p.tw} tiles {p.ntiles} "
                   f"classes {p.class_lmax or p.lmax} shells [{shells}]")
    return "; ".join(out)


def profile_forward(m: TransitModel, T, q, ms_forward: float, trace: str,
                    label: str) -> dict:
    """exact_profile.profile_step of ``forward``."""
    return profile_step(lambda: m.forward(T, q), ms_forward, trace, label)


def device_ms(fn, runs: int = RUNS) -> dict:
    """{"device_ms", "kernels", "port"} per call of fn(): torch.profiler's
    device-side time and count of device kernels over ``runs`` calls
    after a warm-up, and the count of each of the port's kernels
    (exact_profile.PORT_KERNELS, by their device names) among them."""
    from torch.autograd import DeviceType
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    ms, n, port = 0.0, 0, {}
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA:
            us = getattr(ev, "self_device_time_total", None)
            ms += (ev.self_cuda_time_total if us is None else us) / 1e3
            n += ev.count
            for k in PORT_KERNELS:
                if k in ev.key:
                    port[k] = port.get(k, 0) + ev.count / runs
    return {"device_ms": ms / runs, "kernels": n / runs, "port": port}


GRAD_OUTPUTS = ("temps", "coef0", "densm", "alphal", "alphad_f")


def bwd_name(part: str) -> str:
    return "shell_tile_backward" if part == "shell" else "line_tile_backward"


def line_cotangent(m: TransitModel, T0, q0):
    """The cotangent the main path gives the line extinction: d(sum of
    the spectrum) / d(extinction) at the profile (T0, q0), (nl, nwn),
    with the step's geometry (hydrostatic radii on the transit path)."""
    T, q, dens = m._profiles(T0, q0)
    ex = m.line_extinction(T * m.atm.tfct, dens, m.partition(T)).detach()
    ex.requires_grad_(True)
    g, = torch.autograd.grad(m._assemble(T, q, dens, ex, False,
                                         *m.geometry(T, q)).sum(), ex)
    return g.contiguous()


def step_last(m: TransitModel, T, q):
    """tau.last per wavenumber of forward(T, q)."""
    with torch.no_grad():
        Tt, qt, dens = m._profiles(T, q)
        return m._spectrum(Tt, qt, dens, True,
                           geom=m.geometry(Tt, qt)).last


def fd_keep(m: TransitModel, T0, q0, layer: int, h: float):
    """The mask of the wavenumbers whose tau.last stays the same at T0
    and at T0 +- h at ``layer``."""
    base = step_last(m, T0, q0)
    keep = torch.ones_like(base, dtype=torch.bool)
    for sign in (1.0, -1.0):
        T = T0.copy()
        T[layer] += sign * h
        keep &= step_last(m, T, q0) == base
    return keep


def shell_clip(tab, T, kw, unit, r, n_coarse: int):
    """A shell launch's clip mask, from its forward launch."""
    clip = torch.zeros((len(unit.parts), r.shape[0], n_coarse),
                       dtype=torch.uint8, device=T.device)
    shell_tile_extinction(unit, tab, T, rows=r, clip=clip, out=torch.zeros(
        (T.shape[0], n_coarse), device=T.device), **kw)
    return clip


def backward_launches(m: TransitModel, view=None):
    """The backward kernel launches of one gradient step (of the shard
    ``view`` when given), in order:
    yields (part, unit, the band's rows as an int32 and a long tensor)
    with part "lines" (one line_tile_backward launch over the band's
    near and stride-1 classes, unit its LineBand) or "shell" (one
    shell_tile_backward launch, unit the band's ShellBand)."""
    bplan, devs, index = model_view(m, view)
    for i, part, unit in banded.backward_units(bplan, devs, index):
        r = index["rows"][i]
        yield part, unit, r, r.long()


def backward_kernel(tab, T, kw, part, unit, r, g, clip):
    """One backward launch of the banded path: its float64 sums
    (nl, 1 + 4 niso)."""
    if part == "shell":
        return shell_tile_backward(unit, tab, T, g, clip=clip, rows=r, **kw)
    return line_tile_backward(unit, tab, T, g, rows=r, bins_first=True,
                              **kw)


def backward_plain(tab, T, kw, part, unit, sel, g) -> dict:
    """The plain VJP of one backward launch on the band's rows ``sel``:
    float64 sums {output: (nrows, ...)}."""
    tab_r = {k: v[sel] for k, v in tab.items()}
    grads = zero_grads(tab_r, T[sel])
    parts = (unit.parts if part == "shell" else
             [(p, [(dc, gidx)], 1) for p, dc, gidx, _ in unit.units])
    for plan, classes, stride in parts:
        gt = tile_cotangent(g[sel], plan)
        for dc, gidx in classes:
            gc = gt if gidx is None else gt[:, torch.as_tensor(
                gidx, device=gt.device).long()]
            if part == "shell":
                plain_shell_vjp(plan, dc, tab_r, T[sel], gc, stride=stride,
                                gidx=gidx, grads=grads, **kw)
            else:
                plain_line_tiles_vjp(plan, dc, tab_r, T[sel], gc, gidx=gidx,
                                     bins_first=True, grads=grads, **kw)
    return grads


def backward_vs_plain(m: TransitModel, g, label: str, view=None) -> dict:
    """Every backward launch of the banded path (of the shard ``view``
    when given) on its own (one
    line_tile_backward per band over its classes; the shell launch with
    the clip mask of its forward launch) against its plain VJP on the
    same inputs and cotangent ``g``: per output max|a-b| / max|b| <
    GRAD_LAUNCH_TOL.  {kernel: {"max_rel": {output: x},
    "max_abs_temps", "launches"}}."""
    args, kw = file_state(m)
    T = args[0]
    tab = banded.prep_layers(model_view(m, view)[1][0], *args,
                             use_kernel=True)
    res = {}
    for part, unit, r, sel in backward_launches(m, view):
        clip = shell_clip(tab, T, kw, unit, r, m.wns.n) \
            if part == "shell" else None
        acc = backward_kernel(tab, T, kw, part, unit, r, g, clip)
        got = {k: v[sel] for k, v in acc_grads(acc, torch.float64).items()}
        want = backward_plain(tab, T, kw, part, unit, sel, g)
        name = bwd_name(part)
        e = res.setdefault(name, {"max_rel": dict.fromkeys(GRAD_OUTPUTS,
                                                           0.0),
                                  "max_abs_temps": 0.0, "launches": 0})
        for k in GRAD_OUTPUTS:
            a, b = got[k], want[k]
            check(bool(torch.isfinite(a).all()),
                  f"{label} {name}: {k} not finite")
            diff = float((a - b).abs().max())
            scale = float(b.abs().max())
            err = diff / scale if scale > 0 else (0.0 if diff == 0 else
                                                  float("inf"))
            check(err < GRAD_LAUNCH_TOL,
                  f"{label} {name} ({part}): {k} vs plain VJP {err:.3e} >= "
                  f"{GRAD_LAUNCH_TOL}")
            e["max_rel"][k] = max(e["max_rel"][k], err)
            if k == "temps":
                e["max_abs_temps"] = max(e["max_abs_temps"], diff)
        e["launches"] += 1
    return res


def grad_leaves(m: TransitModel, T0, q0):
    return tuple(torch.tensor(np.asarray(a), dtype=torch.float32,
                              device=m.device, requires_grad=True)
                 for a in (T0, q0))


def grad_step(m: TransitModel, T, q):
    """One retrieval gradient step: d(sum of forward(T, q)) / d(T, q)."""
    return torch.autograd.grad(m.forward(T, q).sum(), (T, q))


def max_rel(a, b) -> float:
    """max |a - b| / max |b|."""
    return float((a - b).abs().max() / b.abs().max())


def backward_times(m: TransitModel, g) -> dict:
    """Per backward kernel: the time of its launches of one gradient step
    (CUDA events, median of RUNS), of their plain VJPs, and the bound of
    the work they need on these inputs (FP32, MUFU and byte terms; the
    FP64 part of the kernels' design beside them)."""
    args, kw = file_state(m)
    T = args[0]
    nl, n = m.atm.nlayers, m.wns.n
    tab = banded.prep_layers(m.bdev[0], *args, use_kernel=True)
    niso = tab["alphal"].shape[1]
    launches = list(backward_launches(m))
    clips = {id(u): shell_clip(tab, T, kw, u, r, n)
             for p, u, r, _ in launches if p == "shell"}
    res = {}
    for name in ("line_tile_backward", "shell_tile_backward"):
        mine = [x for x in launches if bwd_name(x[0]) == name]
        if not mine:
            continue
        ms = cuda_ms(lambda: [backward_kernel(tab, T, kw, p, u, r, g,
                                              clips.get(id(u)))
                              for p, u, r, _ in mine])
        plain_ms = cuda_ms(lambda: [backward_plain(tab, T, kw, p, u, sel, g)
                                    for p, u, _, sel in mine], runs=1)
        res[name] = {"ms": ms, "plain_ms": plain_ms, "launches": len(mine)}
    # The work each function needs on these inputs: [FP32 operations,
    # bytes, MUFU operations, operations the kernels run in FP64].
    tables = nbytes_of(*(tab[k] for k in ("alphal", "alphad_f", "coef0",
                                          "densm", "kmax")), T)
    need = {k: [0, tables, 0, 0] for k in res}
    for i, (a, b) in enumerate(m.bplan.slices):
        parts = [(p, pl) for bi, _, p, pl, _, _ in
                 banded.band_parts(m.bplan, m.bdev) if bi == i]
        for key in need:
            plans = [pl for p, pl in parts if bwd_name(p) == key]
            if plans:
                chains = (b - a) * distinct_lines(*plans)
                need[key][0] += OPS_LAYER_LINE * chains
                need[key][2] += MUFU_LAYER_LINE * chains
    for part, unit, r, sel in launches:
        key = bwd_name(part)
        tab_r = {k: v[sel] for k, v in tab.items()}
        nrows = sel.shape[0]
        if part == "shell":
            tw = unit.parts[0][0].tw
            tiles = unit.blocks[:, 0].cpu().numpy().astype(np.int64)
            ncol = int(np.minimum(n - tiles * tw, tw).sum())
            need[key][1] += (nbytes_of(*unit.lines.values(), unit.blocks) +
                             nrows * ncol * (4 + len(unit.parts)) +
                             8 * nrows * (1 + 4 * niso))
            for plan, classes, stride in unit.parts:
                if stride > 1:
                    need[key][0] += OPS_BWD_UPSAMPLE * nrows * ncol
                for dc, gidx in classes:
                    c = shell_counts(plan, dc, tab_r, T[sel], stride=stride,
                                     gidx=gidx, **kw)
                    need[key][0] += c["evals"] * (
                        OPS_BWD_PAIR32 + OPS_BWD_PAIR64 - OPS_BWD_SUM64 +
                        OPS_WFN[plan.wfn_tag])
                    need[key][3] += (OPS_BWD_CHAIN * c["live"] +
                                     OPS_BWD_SUM64 * c["evals"])
                    need[key][2] += MUFU_WFN[plan.wfn_tag] * c["evals"]
            continue
        # Per class, as one launch per class would count them: its line
        # tensors, its columns of the cotangent, the sums.
        for plan, dc, gidx, _ in unit.units:
            ncol = min(n, plan.ntiles * plan.tw) if gidx is None else \
                int(np.minimum(n - np.asarray(gidx) * plan.tw,
                               plan.tw).sum())
            need[key][1] += (nbytes_of(*(dc[k] for k in ("wavn", "elow",
                                                         "gf", "iso",
                                                         "mask"))) +
                             4 * nrows * ncol + 8 * nrows * (1 + 4 * niso))
            w = work_counts(plan, {**dc, "all_wavn": m.bdev[0]["all_wavn"]},
                            tab_r, T[sel], gidx=gidx, bins_first=True, **kw)
            live = run_counts(plan, dc, tab_r, T[sel], gidx=gidx,
                              bins_first=True, **kw)["live"]
            ev = sum(w[x] for x in OPS_REGION)
            need[key][0] += (OPS_BWD_PAIR32 + OPS_BWD_PAIR64 -
                             OPS_BWD_SUM64) * ev
            need[key][3] += OPS_BWD_CHAIN * live + OPS_BWD_SUM64 * ev
            if plan.wfn_tag == "w4":
                need[key][0] += sum(OPS_REGION[x] * w[x] for x in OPS_REGION)
                need[key][2] += sum(MUFU_BWD_REGION[x] * w[x]
                                    for x in OPS_REGION)
            else:
                need[key][0] += OPS_WFN[plan.wfn_tag] * ev
                need[key][2] += MUFU_WFN[plan.wfn_tag] * ev
    for name, (ops, nb, mufu, ops64) in need.items():
        b_ms, b_by, unit = roofline(ops + ops64, nb, mufu)
        res[name].update(bound_ms=b_ms, bound_by=b_by, bound_unit=unit,
                         ops=ops + ops64, ops_fp64_design=ops64, mufu=mufu,
                         bytes=nb,
                         terms_ms={"fp32": 1e3 * (ops + ops64) / PEAK_FP32,
                                   "mufu": 1e3 * mufu / PEAK_MUFU,
                                   "bytes": 1e3 * nb / PEAK_BYTES,
                                   "fp64_design": 1e3 * ops64 / PEAK_FP64})
    return res


ALL_KERNELS = (line_tile_extinction, layer_kmax, shell_tile_extinction,
               line_tile_backward, shell_tile_backward)
EXACT_KERNELS = (profile_scatter, profile_scatter_backward)


def grad_phase(m: TransitModel, requests, label: str,
               fd_model: TransitModel | None = None,
               fd_step: float = FD_STEP) -> dict:
    """Three gradient steps of ``forward`` (launch counts set to 0 just
    before and read just after), then the checks: finite gradients, one
    backward launch per forward launch, each backward launch against its
    plain VJP, the whole gradient against the plain path's, central
    differences in T on two layers (of ``fd_model``'s forward, default
    m's, at ``fd_step``); then the times."""
    for k in ALL_KERNELS:
        k.launches = 0
    leaves = [grad_leaves(m, T0, q0) for T0, q0 in requests]
    grads = [grad_step(m, T, q) for T, q in leaves]
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in ALL_KERNELS}
    for gT, gq in grads:
        check(gT.shape == (m.atm.nlayers,) and bool(torch.isfinite(gT).all())
              and bool(torch.isfinite(gq).all()) and float(gT.abs().max()) > 0,
              f"{label}: gradient not finite or zero")
    per_step = {k: 0 for k in ("line_tile_backward", "shell_tile_backward")}
    for part, *_ in backward_launches(m):
        per_step[bwd_name(part)] += 1
    for k, v in per_step.items():
        check(launches[k] == 3 * v, f"{label}: {k} launched {launches[k]} "
              f"times in 3 steps, the plan asks {3 * v}")
    check(launches["layer_kmax"] == 3, f"{label}: layer_kmax launched "
          f"{launches['layer_kmax']} times in 3 steps")
    # The whole gradient: kernel path against the plain path (plain
    # forward, plain VJPs) on the card.
    m.use_kernel = False
    plain = grad_step(m, *leaves[0])
    # And against the plain path with the Voigt pair in float64 (the
    # kernels' pair is float32, as JAX's).
    kernel_lbl.PAIR_DTYPE = torch.float64
    try:
        plain64 = grad_step(m, *leaves[0])
    finally:
        kernel_lbl.PAIR_DTYPE = None
    m.use_kernel = True
    err_T, err_q = (max_rel(a, b) for a, b in zip(grads[0], plain))
    check(max(err_T, err_q) < GRAD_TOL, f"{label}: gradient kernel path vs "
          f"plain path T {err_T:.3e} q {err_q:.3e} >= {GRAD_TOL}")
    err64 = {x: max_rel(a, b) for x, a, b in zip("Tq", grads[0], plain64)}
    check(max(err64.values()) < GRAD_TOL, f"{label}: gradient kernel path "
          f"vs the plain path with a float64 pair {err64} >= {GRAD_TOL}")
    # Central differences in T at the two layers of largest |dF/dT|, over
    # the wavenumbers whose tau.last the step does not move.
    T0, q0 = (np.asarray(a, dtype=np.float64) for a in requests[0])
    gT = grads[0][0].double().cpu().numpy()
    fdm = m if fd_model is None else fd_model
    fd = {}
    for layer in np.argsort(-np.abs(gT))[:2].tolist():
        keep = fd_keep(fdm, T0, q0, layer, fd_step)
        T, q = grad_leaves(m, T0, q0)
        g = float(torch.autograd.grad((m.forward(T, q) * keep).sum(),
                                      T)[0][layer])
        f = []
        with torch.no_grad():
            for sign in (1.0, -1.0):
                T = T0.copy()
                T[layer] += sign * fd_step
                f.append(float((fdm.forward(T, q0) * keep).double().sum()))
        d = (f[0] - f[1]) / (2.0 * fd_step)
        fd[layer] = {"fd": d, "grad": g, "rel": abs(d - g) / abs(d),
                     "fd_dtype": str(fdm.dtype), "step": fd_step,
                     "last_moved": int((~keep).sum())}
        check(fd[layer]["rel"] < FD_RTOL, f"{label}: layer {layer} "
              f"central difference {d:.6e} vs gradient {g:.6e}")
    g = line_cotangent(m, T0, q0)
    launch_err = backward_vs_plain(m, g, label)
    T, q = leaves[0]
    Tn, qn = T.detach(), q.detach()
    ms_fwd = cuda_ms(lambda: m.forward(Tn, qn))
    ms_fb = cuda_ms(lambda: grad_step(m, T, q))
    return {"launches": launches, "per_step": {k: v / 3 for k, v in
                                               launches.items()},
            "vs_plain_path": {"T": err_T, "q": err_q},
            "vs_plain_path_pair64": err64, "fd": fd,
            "launch_vs_plain": launch_err, "forward_ms": ms_fwd,
            "forward_backward_ms": ms_fb, "ratio": ms_fb / ms_fwd,
            "times": backward_times(m, g)}


def batch_phase(m: TransitModel, label: str) -> dict:
    """forward_batch on BATCH perturbed profiles (numpy, from a seed)
    against BATCH calls of forward, and its gradient against the sum of
    theirs; launch counts of one batched gradient step; times."""
    rng = np.random.default_rng(11)
    T0 = np.asarray(m.atm.temp, dtype=np.float64)
    q0 = np.asarray(m.atm.q, dtype=np.float64)
    Tb = T0[None] + rng.normal(0.0, 30.0, (BATCH, T0.shape[0]))
    qb = q0[None] * (1.0 + 0.1 * rng.uniform(-1, 1, (BATCH,) + q0.shape))
    T, q = grad_leaves(m, Tb, qb)
    for k in ALL_KERNELS:
        k.launches = 0
    spec = m.forward_batch(T, q)
    gT, gq = torch.autograd.grad(spec.sum(), (T, q))
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in ALL_KERNELS}
    check(spec.shape == (BATCH, m.wns.n) and bool(torch.isfinite(spec).all())
          and bool(torch.isfinite(gT).all()), f"{label}: batch not finite")
    loop, gl = [], []
    for i in range(BATCH):
        t, qq = grad_leaves(m, Tb[i], qb[i])
        s = m.forward(t, qq)
        loop.append(s.detach())
        gl.append(torch.autograd.grad(s.sum(), (t, qq)))
    loop = torch.stack(loop)
    err = float(((spec.detach() - loop).abs() / loop.abs()).max())
    check(err <= BATCH_TOL, f"{label}: forward_batch vs forward {err:.3e} > "
          f"{BATCH_TOL}")
    err_T = max_rel(gT, torch.stack([a for a, _ in gl]))
    err_q = max_rel(gq, torch.stack([b for _, b in gl]))
    check(max(err_T, err_q) < BATCH_GRAD_TOL, f"{label}: forward_batch "
          f"gradient vs the loop's T {err_T:.3e} q {err_q:.3e}")
    Tn, qn = T.detach(), q.detach()
    ms = cuda_ms(lambda: m.forward_batch(Tn, qn))
    ms_fb = cuda_ms(lambda: torch.autograd.grad(m.forward_batch(T, q).sum(),
                                                (T, q)))
    return {"launches": launches, "vs_loop": err,
            "grad_vs_loop": {"T": err_T, "q": err_q}, "ms_batch": ms,
            "ms_member": ms / BATCH, "ms_batch_grad": ms_fb,
            "ms_member_grad": ms_fb / BATCH}


def radii_vs_float64(m: TransitModel, T0, q0) -> float:
    """The card's float32 hydrostatic radii of the step at (T0, q0)
    against radpress_torch in float64 on the CPU: max |a - b| / |b|."""
    got = m.geometry(m._t(T0), m._t(q0))[0].double().cpu()
    q64 = torch.as_tensor(q0, dtype=torch.float64)
    mass = torch.as_tensor(m.mol.mass, dtype=torch.float64)[:, None]
    mm = (1.0 / torch.sum(q64 / mass, dim=0) if m.atm.by_mass
          else torch.sum(q64 * mass, dim=0))
    cfg = m.cfg
    want = radpress_torch(cfg.gsurf, cfg.refpress, cfg.refradius,
                          torch.as_tensor(T0, dtype=torch.float64), mm,
                          m.atm.press, m.rfct)
    return float(((got - want).abs() / want.abs()).max())


def modlevel_m1_vs_plain(m: TransitModel, requests) -> dict:
    """modlevel = -1 (the opaque-disc modulation, modulationm1) through
    the kernels against the plain path: the same wavenumbers reach
    toomuch, the radii squared agree within SPECTRUM_REL_TOL."""
    m.cfg.modlevel = -1
    try:
        got = [m.forward(T, q) for T, q in requests]
        m.use_kernel = False
        want = [m.forward(T, q) for T, q in requests]
    finally:
        m.use_kernel = True
        m.cfg.modlevel = 1
    err, reached = 0.0, 0
    for a, b in zip(got, want):
        check(torch.equal(a == -1.0, b == -1.0),
              "modlevel -1: toomuch reached at other wavenumbers")
        ok = b != -1.0
        check(bool(torch.isfinite(a).all()), "modlevel -1: not finite")
        reached += int(ok.sum())
        err = max(err, float(((a - b).abs() / b.abs())[ok].max()))
    check(err <= SPECTRUM_REL_TOL, f"modlevel -1: kernel path vs plain "
          f"{err:.3e} > {SPECTRUM_REL_TOL}")
    return {"max_rel": err, "reached": reached / len(requests)}


def modulation_gather(tau, last, ips, ip_fct, srad, Wmod):
    """The modulation integral as transit_tpu writes it
    (rt/transmission.py:76-78): each wavenumber gathers its weight row
    Wmod[count], (nwn, nip), and sums; timed against the port's form, a
    matrix product and one gather per row (rt/transmission.py)."""
    nwn, ipn = tau.shape
    ipv_desc = ips * ip_fct
    ipv_asc = ipv_desc.flip(-1)
    idx = torch.arange(ipn, device=tau.device)
    rint = torch.where(idx[None, :] <= last[:, None],
                       torch.exp(-tau) * ipv_desc[None, :],
                       torch.zeros((), device=tau.device)).flip(-1)
    count = torch.clamp(last + 2, max=ipn)
    integ = torch.sum(Wmod[count] * rint, dim=1)
    return (ipv_asc[-1] * ipv_asc[-1] - 2.0 * integ) / (srad * srad)


def transit_times(m: TransitModel, T0, q0) -> dict:
    """Times of the transit step's own parts (CUDA events, median of
    RUNS): the geometry (radii, path weights, modulation table) forward
    and with its backward; the modulation integral in both forms, with
    the backward into tau and a traced table (as under hydrostatic
    radii), and the two forms against each other."""
    T = m._t(T0).requires_grad_(True)
    q = m._t(q0)
    geom = m.geometry(T, q)
    wts = [torch.randn(g.shape, device=g.device,
                       generator=torch.Generator(g.device).manual_seed(i))
           for i, g in enumerate(geom)]

    def geom_grad():
        out = m.geometry(T, q)
        return torch.autograd.grad(sum((g * w).sum() for g, w in
                                       zip(out, wts)), T)

    Tn = T.detach()
    ms_geom = cuda_ms(lambda: m.geometry(Tn, q))
    ms_geom_grad = cuda_ms(geom_grad)
    with torch.no_grad():
        Tt, qt, dens = m._profiles(Tn, q)
        r = m._spectrum(Tt, qt, dens, True, geom=m.geometry(Tt, qt))
    radii, _, Wmod = (g.detach() for g in m.geometry(Tn, q))
    tau = r.tau.detach().requires_grad_(True)
    Wmod = Wmod.requires_grad_(True)
    ips = radii.flip(0)
    srad = m.cfg.starrad * SUNRADIUS
    forms = {
        "matmul": lambda: modulation(tau, r.last, ips, m.rfct, srad,
                                     m.cfg.toomuch, Wmod=Wmod),
        "gather": lambda: modulation_gather(tau, r.last, ips, m.rfct, srad,
                                            Wmod)}
    with torch.no_grad():
        a, b = (f() for f in forms.values())
    err = float(((a - b).abs() / b.abs()).max())
    check(err <= SPECTRUM_REL_TOL, f"modulation forms differ by {err:.3e}")
    res = {"geometry_ms": ms_geom, "geometry_grad_ms": ms_geom_grad,
           "modulation_forms_max_rel": err}
    steps = {"geometry": lambda: m.geometry(Tn, q),
             "geometry_grad": geom_grad}
    for name, f in forms.items():
        steps[f"modulation_{name}"] = f
        steps[f"modulation_{name}_grad"] = (
            lambda f=f: torch.autograd.grad(f().sum(), (tau, Wmod)))
    for name, f in steps.items():
        if name.startswith("modulation"):
            res[f"{name}_ms"] = cuda_ms(f)
    return res, steps


def nograd(f):
    def run(*args):
        with torch.no_grad():
            return f(*args)
    return run


def reserved_mib() -> float:
    """MiB the caching allocator holds once its free blocks are returned:
    live tensors and the private pools of the live CUDA graphs."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return torch.cuda.memory_reserved() / 2 ** 20


def graph_requests(m: TransitModel, requests, batch: int = 0):
    """The requests [(T, q) numpy] as tensors of the model; with
    ``batch``, each a batch of that many profiles: the request's and
    members perturbed from it (numpy, from a seed)."""
    rng = np.random.default_rng(23)
    out = []
    for T0, q0 in requests:
        T0, q0 = np.asarray(T0, np.float64), np.asarray(q0, np.float64)
        if batch:
            T0 = T0[None] + np.concatenate([np.zeros((1,) + T0.shape),
                                           rng.normal(0.0, 30.0, (
                                               batch - 1,) + T0.shape)])
            q0 = q0[None] * (1.0 + 0.1 * rng.uniform(-1, 1, (batch,) +
                                                     q0.shape))
        out.append((m._t(T0), m._t(q0)))
    return out


def graph_phase(m: TransitModel, requests, label: str, atomics: bool = False,
                batch: int = 0, profile: str | None = None, fwd=None,
                eager=None) -> dict:
    """The path's step through ``m.make_forward()`` (CUDA graph replays;
    ``fwd``: another compiled step of ``m``, such as the sharded one)
    against the eager step (``forward``; ``forward_batch`` with ``batch``
    members a request; ``eager``: another) on the same three requests:
    spectra bit for bit (``atomics``: within GRAPH_TOL of the max),
    gradients of the spectrum's sum in T and q within GRAPH_TOL of the
    max (bit for bit noted), request 1's spectrum and gradients unchanged
    by requests 2 and 3; the capture times, the graphed and eager forward
    and gradient step (CUDA events, median of RUNS), and the device time
    and device kernels of one replay and of one eager step
    (torch.profiler: the launch counters do not move on a replay), and
    the memory (reserved_mib) the forward and the gradient captures
    added, and what the timings' replays added after them (a replay
    reuses its graph's pool).  With
    ``profile`` (a trace path) also profile_step passes of the graphed
    forward and gradient step (traces ``<stem>_graph_<label>``,
    ``<stem>_graph_grad_<label>``).  Every check raises on a miss."""
    if eager is None:
        eager = m.forward_batch if batch else m.forward
    reqs = graph_requests(m, requests, batch)
    fwd = m.make_forward() if fwd is None else fwd
    mib = [reserved_mib()]
    t0 = time.perf_counter()
    with torch.no_grad():
        fwd(*reqs[0])
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    mib.append(reserved_mib())
    with torch.no_grad():
        got = [fwd(T, q) for T, q in reqs[:1]]
        first = got[0].clone()
        got += [fwd(T, q) for T, q in reqs[1:]]
        want = [eager(T, q) for T, q in reqs]
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        check(a.shape == b.shape and bool(torch.isfinite(a).all()),
              f"{label}: graphed spectrum {tuple(a.shape)}, eager "
              f"{tuple(b.shape)}, or not finite")
    bitwise = all(torch.equal(a, b) for a, b in zip(got, want))
    err = max(max_rel(a, b) for a, b in zip(got, want))
    check(bitwise or (atomics and err <= GRAPH_TOL), f"{label}: graphed vs "
          f"eager spectrum max_rel {err:.3e} (bit for bit asked"
          f"{'' if not atomics else f' or <= {GRAPH_TOL}'})")
    check(torch.equal(got[0], first) and not torch.equal(got[0], got[1]),
          f"{label}: request 1's spectrum changed with request 2")

    leaves = [tuple(x.clone().requires_grad_(True) for x in r) for r in reqs]
    t0 = time.perf_counter()
    gg = []
    for T, q in leaves:
        gg.append(torch.autograd.grad(fwd(T, q).sum(), (T, q)))
        if len(gg) == 1:
            torch.cuda.synchronize()
            grad_capture_s = time.perf_counter() - t0
            held = [g.clone() for g in gg[0]]
            mib.append(reserved_mib())
    ge = [torch.autograd.grad(eager(T, q).sum(), (T, q)) for T, q in leaves]
    torch.cuda.synchronize()
    gerr = {x: max(max_rel(a[i], b[i]) for a, b in zip(gg, ge))
            for i, x in enumerate("Tq")}
    gbit = all(torch.equal(x, y) for a, b in zip(gg, ge)
               for x, y in zip(a, b))
    check(all(bool(torch.isfinite(g).all()) for a in gg for g in a) and
          max(gerr.values()) <= GRAPH_TOL, f"{label}: graphed vs eager "
          f"gradient {gerr} > {GRAPH_TOL}")
    check(all(torch.equal(a, b) for a, b in zip(gg[0], held)),
          f"{label}: request 1's gradient changed with request 2")

    T, q = reqs[0]
    lT, lq = leaves[0]
    ms = {"forward_ms": cuda_ms(nograd(lambda: fwd(T, q))),
          "eager_forward_ms": cuda_ms(nograd(lambda: eager(T, q))),
          "gradient_ms": cuda_ms(lambda: torch.autograd.grad(
              fwd(lT, lq).sum(), (lT, lq))),
          "eager_gradient_ms": cuda_ms(lambda: torch.autograd.grad(
              eager(lT, lq).sum(), (lT, lq)))}
    replay = device_ms(nograd(lambda: fwd(T, q)))
    mib.append(reserved_mib())
    once = device_ms(nograd(lambda: eager(T, q)))
    out = {"capture_s": capture_s, "grad_capture_s": grad_capture_s,
           "bitwise": bitwise, "max_rel": err, "grad_bitwise": gbit,
           "grad_max_rel": gerr, **ms,
           "replay_device_ms": replay["device_ms"],
           "replay_kernels": replay["kernels"],
           "replay_port_kernels": replay["port"],
           "eager_device_ms": once["device_ms"],
           "eager_kernels": once["kernels"],
           "capture_mib": {"forward": mib[1] - mib[0],
                           "gradient": mib[2] - mib[1],
                           "after_timings": mib[3] - mib[2]}}
    if profile:
        trace = Path(profile)
        tag = label.replace(" ", "_")
        out["profile_forward"] = profile_step(
            nograd(lambda: fwd(T, q)), ms["forward_ms"], str(
                trace.with_name(f"{trace.stem}_graph_{tag}{trace.suffix}")),
            f"graph {label}")
        out["profile_grad"] = profile_step(
            lambda: torch.autograd.grad(fwd(lT, lq).sum(), (lT, lq)),
            ms["gradient_ms"], str(trace.with_name(
                f"{trace.stem}_graph_grad_{tag}{trace.suffix}")),
            f"graph {label} grad")
    del fwd
    gc.collect()         # the graphs' autograd Functions are cyclic garbage
    torch.cuda.empty_cache()
    return out


def graph_settings(m: TransitModel, T0, q0) -> dict:
    """Settings are fixed at make_forward(): on the model with a cloud
    deck (top GRAPH_CLOUDTOP[0]), a callable made before set_cloudtop(
    GRAPH_CLOUDTOP[1]) equals the eager forward with the old deck, one
    made after it the eager forward with the new deck, bit for bit; the
    model's own settings are put back."""
    T, q = m._t(T0), m._t(q0)
    own = (m.cfg.cloudtop, m._cloud)
    m.cfg.cloudtop = GRAPH_CLOUDTOP[0]
    m._cloud = m._parse_cloud()
    try:
        with torch.no_grad():
            old, before = m.make_forward(), m.forward(T, q)
            old(T, q)
            m.set_cloudtop(GRAPH_CLOUDTOP[1])
            new, after = m.make_forward(), m.forward(T, q)
            moved = max_rel(after, before)
            check(moved > 1e-3, f"set_cloudtop moved the spectrum by "
                  f"{moved:.3e} only")
            check(torch.equal(old(T, q), before) and
                  torch.equal(new(T, q), after), "make_forward did not fix "
                  "the cloud deck at the call")
    finally:
        m.cfg.cloudtop, m._cloud = own
    del old, new
    gc.collect()
    torch.cuda.empty_cache()
    return {"moved_max_rel": moved}


def graph_text(g: dict, card: str) -> str:
    spec = ("bit for bit" if g["bitwise"] else
            f"max_rel {g['max_rel']:.3e}")
    grad = ("bit for bit" if g["grad_bitwise"] else
            f"max_rel {json.dumps(g['grad_max_rel'])}")
    return (f"graphed vs eager: spectra {spec}, gradients {grad}; forward "
            f"{g['forward_ms']:.3f} ms graphed, {g['eager_forward_ms']:.3f}"
            f" ms eager; gradient step {g['gradient_ms']:.3f} ms graphed, "
            f"{g['eager_gradient_ms']:.3f} ms eager ({card}); one replay "
            f"{g['replay_device_ms']:.3f} device ms in "
            f"{g['replay_kernels']:g} kernels, the port's "
            f"{json.dumps(g['replay_port_kernels'])} (an eager step "
            f"{g['eager_device_ms']:.3f} device ms in "
            f"{g['eager_kernels']:g} kernels); memory the captures hold "
            f"{json.dumps(g['capture_mib'])} MiB; capture "
            f"{g['capture_s']:.2f} s, with the gradient "
            f"{g['grad_capture_s']:.2f} s")


def hmc_phase(m: TransitModel) -> dict:
    """HMC (transit_tpu_torch.retrieval) over HMC_CHAINS chains through
    forward_batch: an HMC_KNOTS-knot log-temperature profile
    (knot_profile), 1% noise on the spectrum the model makes at the
    truth, HMC_LEAPFROG leapfrog steps, HMC_SAMPLES samples, a seeded
    generator on the card.  Fails on a non-finite sample or log
    posterior, or on no accepted proposal.  Also times the leapfrog
    gradient evaluation through ``make_forward()``'s graphed batched
    step, which must equal the eager one within GRAPH_TOL."""
    nl = m.atm.nlayers
    q = m._t(m.atm.q)

    def fwd(z):
        T = knot_profile(torch.exp(z), nl)
        return m.forward_batch(T, q.expand((z.shape[0],) + q.shape))

    z_true = torch.full((HMC_KNOTS,), float(np.log(np.mean(m.atm.temp))),
                        dtype=m.dtype, device=m.device)
    with torch.no_grad():
        obs = fwd(z_true[None])[0]
    sigma = 1e-2 * float(obs.abs().mean())
    vg = batched_value_and_grad(gaussian_logprob(
        fwd, obs, sigma, prior_mean=float(z_true[0]), prior_sigma=0.5))
    gen = torch.Generator(device=m.device).manual_seed(7)
    x0 = z_true[None] + 0.01 * torch.randn(
        (HMC_CHAINS, HMC_KNOTS), generator=gen, dtype=m.dtype,
        device=m.device)
    ms_eval = cuda_ms(lambda: vg(x0))
    # The same evaluation through the graphed batched step:
    gfwd = m.make_forward()

    def fwd_graph(z):
        T = knot_profile(torch.exp(z), nl)
        return gfwd(T, q.expand((z.shape[0],) + q.shape))

    vg_graph = batched_value_and_grad(gaussian_logprob(
        fwd_graph, obs, sigma, prior_mean=float(z_true[0]), prior_sigma=0.5))
    (lp_e, g_e), (lp_g, g_g) = vg(x0), vg_graph(x0)
    graph_err = {"logp": max_rel(lp_g, lp_e), "grad": max_rel(g_g, g_e)}
    check(max(graph_err.values()) <= GRAPH_TOL, f"hmc: the graphed "
          f"evaluation vs the eager one {graph_err} > {GRAPH_TOL}")
    ms_eval_graph = cuda_ms(lambda: vg_graph(x0))
    del gfwd, vg_graph
    gc.collect()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    samples, accept, (xf, lpf) = hmc_sample(
        None, x0, gen, step_size=HMC_STEP, n_leapfrog=HMC_LEAPFROG,
        n_samples=HMC_SAMPLES, vg_fn=vg)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    acc = float(accept.float().mean())
    check(samples.shape == (HMC_SAMPLES, HMC_CHAINS, HMC_KNOTS)
          and bool(torch.isfinite(samples).all())
          and bool(torch.isfinite(lpf).all()),
          "hmc: a sample or log posterior is not finite")
    check(acc > 0, "hmc: no proposal accepted")
    return {"chains": HMC_CHAINS, "knots": HMC_KNOTS,
            "leapfrog": HMC_LEAPFROG, "samples": HMC_SAMPLES,
            "acceptance": acc, "ms_per_gradient_eval": ms_eval,
            "ms_per_gradient_eval_graph": ms_eval_graph,
            "graph_vs_eager": graph_err,
            "ms_per_sample": 1e3 * dt / HMC_SAMPLES,
            "max_abs_dz": float((samples - z_true).abs().max())}


def exact_config() -> TransitConfig:
    """benchmarks/data/hj/hj_ref.cfg, the configuration the reference C
    binary ran (exact mode's table at its defaults, 60 x 60 widths), its
    files taken from this checkout; no output file."""
    cfg = load_config(str(HJ / "hj_ref.cfg"))
    for k in ("atm", "linedb", "molfile"):
        setattr(cfg, k, str(HJ / Path(getattr(cfg, k)).name))
    cfg.csfile = ",".join(str(HJ / Path(f).name)
                          for f in cfg.csfile.split(","))
    cfg.outspec = None
    return cfg


def exact_table(cfg: TransitConfig, device):
    """Exact mode's profile table of cfg built on ``device``, as the
    model builds it."""
    wns, owns = make_wn_sampling(wnlow=cfg.wnlow, wnhigh=cfg.wnhigh,
                                 wndelt=cfg.wndelt, wnosamp=cfg.wnosamp,
                                 wnfct=cfg.wnfct)
    return build_profile_table(
        dwn=wns.d / owns.o, nwave=owns.n, nwidth=cfg.nwidth, ndop=cfg.ndop,
        nlor=cfg.nlor, dmin=cfg.dmin, dmax=cfg.dmax, lmin=cfg.lmin,
        lmax=cfg.lmax, device=device)


def exact_groups(m: TransitModel, T=None):
    """lbl.layer_groups of the exact model's forward at the temperatures
    T (numpy; default the file's) and the file's abundances, and its
    ScatterTables."""
    Tt, qt, dens = m._profiles(m.atm.temp if T is None else T, m.atm.q)
    grp = layer_groups(m.dev, Tt * m.atm.tfct, dens, m.partition(Tt),
                       m._molm_t, m._molrad_t, wn0=float(m.wns.v[0]),
                       ethresh=m.cfg.ethreshold)
    return grp, scatter_tables(m.plan, m.dev)


def synthetic_scatter(device, nl: int = SYN_SHAPE[0], seed: int = 7,
                      tiles=None):
    """A synthetic profile-scatter case of SYN_SHAPE's groups and bins
    that reaches every path of the kernels: three isotope runs of 300,
    250 and 150 groups (700, not a multiple of the tile); run 0 spread
    over the whole row, its first and last group at bins 0 and n_coarse -
    1 (windows clipped at both ends; tiles wider than the shared
    segment), run 1 packed into 600 bins (tiles in the segment), run 2
    with profiles of half size 12000 fine bins (ofactor 4: windows of
    6001 bins, wider than the segment); layer 1, when there is one,
    keeps no group, and a quarter of the others' groups are dropped.
    ``tiles``: a tile table to use instead of lbl.scatter_tiles'.
    Returns (g_k, keep, g_idop, ilor, ScatterTables) on ``device``."""
    _, ng, n_coarse = SYN_SHAPE
    rng = np.random.default_rng(seed)
    of, runs = 4, (300, 250, 150)
    psize = np.array([[5, 9], [14, 21], [40, 12000]], dtype=np.int32)
    sizes = 2 * psize.ravel() + 1
    base = np.concatenate([[0], np.cumsum(sizes)[:-1]]).reshape(psize.shape)
    flat = rng.random(int(sizes.sum())).astype(np.float32)
    g_iso = np.repeat(np.arange(3), runs).astype(np.int32)
    idwn = np.concatenate([
        np.sort(rng.integers(0, n_coarse, runs[0])),
        np.sort(rng.integers(1000, 1600, runs[1])),
        np.sort(rng.integers(0, n_coarse, runs[2]))])
    idwn[0], idwn[runs[0] - 1] = 0, n_coarse - 1
    iown = idwn * of + rng.integers(0, of + 1, ng)
    g_idop = rng.integers(0, psize.shape[0], (nl, ng)).astype(np.int32)
    ilor = np.zeros((nl, 3), dtype=np.int32)
    ilor[:, 2] = 1                     # run 2 on the wide column
    g_k = ((0.1 + rng.random((nl, ng))) *
           (rng.random((nl, ng)) > 0.25)).astype(np.float32)
    if nl > 1:
        g_k[1] = 0.0
    tiles = scatter_tiles(g_iso) if tiles is None else tiles

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    s = ScatterTables(g_iso=t(g_iso), g_iown=t(iown.astype(np.int32)),
                      g_idwn=t(idwn.astype(np.int32)), profsize=t(psize),
                      profbase=t(base.astype(np.int32)), profflat=t(flat),
                      ofactor=of, n_coarse=n_coarse,
                      tiles=t(np.asarray(tiles, dtype=np.int32)))
    return t(g_k), t(g_k != 0), t(g_idop), t(ilor), s


def scatter_vs_plain(g_k, keep, g_idop, ilor, s, ct, label: str) -> dict:
    """One profile_scatter and one profile_scatter_backward launch
    against their plain versions: the forward max|a-b| / (|a| + 1e-6
    max|a|) < KERNEL_REL_TOL, its pair counter equal to the host count
    (lbl.scatter_pairs); the backward, on the cotangent ``ct``, bit for
    bit.  Returns the errors, the pair count and the tiles' spans
    against the kernels' shared segment."""
    args = (g_k, g_idop, ilor, s)
    stats = torch.zeros(1, dtype=torch.int64, device=g_k.device)
    got = profile_scatter(*args, stats=stats)
    want = profile_scatter_plain(*args)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()) and float(want.max()) > 0,
          f"{label}: profile_scatter not finite, or plain zero")
    err = rel_err(want, got)
    check(err < KERNEL_REL_TOL, f"{label}: profile_scatter vs plain "
          f"{err:.3e} >= {KERNEL_REL_TOL}")
    host = scatter_pairs(*args)
    check(int(stats[0]) == host, f"{label}: pair counter {int(stats[0])} "
          f"!= host count {host}")
    a = profile_scatter_backward(ct, keep, *args[1:])
    b = profile_scatter_plain_vjp(ct, keep, *args[1:])
    check(bool(torch.isfinite(a).all()) and torch.equal(a, b),
          f"{label}: profile_scatter_backward vs plain VJP not bit for "
          f"bit: max|a-b| / max|b| {max_rel(a, b):.3e}")
    spans = tile_spans(g_k != 0, g_idop, ilor, s)
    return {"fwd_max_rel": err, "fwd_max_abs": float((got - want).abs()
                                                     .max()),
            "bwd_max_rel": max_rel(a, b),
            "bwd_max_abs": float((a - b).abs().max()), "pairs": host,
            "tiles_in_segment": int(((spans > 0) &
                                     (spans <= SCATTER_SEGMENT)).sum()),
            "tiles_wider": int((spans > SCATTER_SEGMENT).sum()),
            "widest_span": int(spans.max())}


def exact_vs_plain(m: TransitModel, g, label: str) -> dict:
    """:func:`scatter_vs_plain` at the file's temperatures and 50 K
    above and below, on the main path's cotangent ``g``, and on
    :func:`synthetic_scatter` (a seeded cotangent), whose wide tiles
    take the kernels' global-memory path (checked: some tile spans more
    than the shared segment)."""
    T = np.asarray(m.atm.temp, dtype=np.float64)
    res = {"fwd_max_rel": 0.0, "fwd_max_abs": 0.0, "bwd_max_rel": 0.0,
           "bwd_max_abs": 0.0, "pairs": {}, "tiles": {}}
    cases = [(name, t) for name, t in (("file", T), ("+50K", T + 50.0),
                                       ("-50K", T - 50.0))]
    for name, t in cases + [("synthetic", None)]:
        if t is None:
            g_k, keep, g_idop, ilor, s = synthetic_scatter(m.device)
            ct = torch.as_tensor(np.random.default_rng(3).standard_normal(
                (g_k.shape[0], s.n_coarse)), dtype=torch.float32,
                device=m.device)
            r = scatter_vs_plain(g_k, keep, g_idop, ilor, s, ct,
                                 f"{label} {name}")
            check(r["tiles_wider"] > 0 and r["tiles_in_segment"] > 0,
                  f"{label} {name}: tiles {r}: not both paths")
        else:
            grp, s = exact_groups(m, t)
            r = scatter_vs_plain(grp["g_k"], grp["keep"], grp["g_idop"],
                                 grp["ilor"], s, g, f"{label} {name}")
        for k in ("fwd_max_rel", "fwd_max_abs", "bwd_max_rel",
                  "bwd_max_abs"):
            res[k] = max(res[k], r[k])
        res["pairs"][name] = r["pairs"]
        res["tiles"][name] = {k: r[k] for k in (
            "tiles_in_segment", "tiles_wider", "widest_span")}
    return res


def table_ulps(a, b) -> tuple:
    """(max ulp distance, count of values that differ) of two float32
    profile tables of equal layout; raises on another layout."""
    for k in ("aDop", "aLor", "profsize", "base"):
        check(np.array_equal(getattr(a, k), getattr(b, k)),
              f"profile tables differ in {k}")
    check(a.flat.shape == b.flat.shape, "profile tables differ in size")
    d = np.abs(a.flat.view(np.int32).astype(np.int64) -
               b.flat.view(np.int32).astype(np.int64))
    return int(d.max()), int((d != 0).sum())


def table_elements(mask, g_idop, ilor, s) -> int:
    """The distinct profile-table elements the scatter reads on this
    data: the flat indices pbase + ofactor*j - offset of the pairs that
    lbl.scatter_pairs counts over the (layer, group) entries of ``mask``
    (a layer's groups share a few dozen profiles, and layers share them
    too); 10 layers at a time, to bound the pair-expanded indices."""
    seen = torch.zeros(s.profflat.shape[0], dtype=torch.bool,
                       device=mask.device)
    of, layers = s.ofactor, 10
    for a in range(0, mask.shape[0], layers):
        psize, pbase, offset, minj, maxj = scatter_geometry(
            g_idop[a:a + layers], ilor[a:a + layers], s)
        lo = torch.maximum(minj, -torch.div(-offset, of,
                                            rounding_mode="floor"))
        hi = torch.minimum(maxj, torch.div(offset + 2 * psize, of,
                                           rounding_mode="floor"))
        n = torch.where(mask[a:a + layers], (hi - lo + 1).clamp_min(0), 0)
        live = n > 0
        n = n[live]
        first = (pbase - offset + of * lo)[live]
        step = (torch.arange(int(n.sum()), device=mask.device) -
                torch.repeat_interleave(torch.cumsum(n, 0) - n, n))
        seen[torch.repeat_interleave(first, n) + of * step] = True
    return int(seen.sum())


def exact_bounds(grp, s) -> dict:
    """{name: {"bound_ms", "bound_by", "pairs", "table_elements"}} of the
    two profile-scatter functions on this data, each input read once and
    each output written once: per (layer, group, j) pair 2 FP32
    operations (a multiply, an add); the distinct table elements the
    pairs read (:func:`table_elements`), 4 bytes each; the forward reads
    g_k and the Doppler index of the groups with g_k != 0 and writes the
    (nl, s.nm, n_coarse) output, the backward reads keep, the Doppler
    index of the kept groups and the (nl, n_coarse) cotangent and writes
    the (nl, ng) cotangent of g_k; both read ilor and the plan's and
    table's index rows."""
    g_k, keep, g_idop, ilor = (grp[k] for k in ("g_k", "keep", "g_idop",
                                                "ilor"))
    rows = nbytes_of(ilor, s.g_iso, s.g_iown, s.g_idwn, s.profsize,
                     s.profbase)
    line = 4 * g_k.shape[0] * s.nm * s.n_coarse
    out = {}
    for name, mask, other in (
            ("profile_scatter", g_k != 0, nbytes_of(g_k)),
            ("profile_scatter_backward", keep,
             nbytes_of(keep) + nbytes_of(g_k))):
        pairs = scatter_pairs(mask, g_idop, ilor, s)
        cells = table_elements(mask, g_idop, ilor, s)
        nbytes = (4 * cells + other + g_idop.element_size() *
                  int(mask.sum()) + rows + line)
        b_ms, b_by, _ = roofline(2 * pairs, nbytes)
        out[name] = {"bound_ms": b_ms, "bound_by": b_by, "pairs": pairs,
                     "table_elements": cells}
    return out


def exact_fd_step(m64: TransitModel, T0, layer: int):
    """The largest step h (EXACT_FD_STEP halved, down to EXACT_FD_MIN K)
    at which T0 +- h at ``layer`` moves no (layer, group) Doppler index,
    no (layer, isotope) Lorentz index and no keep flag of the float64
    model ``m64`` (a central difference across such a jump is not a
    derivative); None when every step moves one."""
    def state(T):
        grp, _ = exact_groups(m64, T)
        return [grp[k] for k in ("g_idop", "ilor", "keep")]

    base = state(T0)
    h = EXACT_FD_STEP
    while h >= EXACT_FD_MIN:
        same = True
        for sign in (1.0, -1.0):
            T = T0.copy()
            T[layer] += sign * h
            same &= all(torch.equal(a, b) for a, b in zip(state(T), base))
        if same:
            return h
        h /= 2.0
    return None


def exact_grad_phase(m: TransitModel, requests, label: str) -> dict:
    """Three gradient steps of the exact path (launch counts set to 0
    just before and read just after): finite, one profile_scatter and
    one profile_scatter_backward launch each; each against the plain
    path's gradient (GRAD_TOL); central differences in T with the
    float64 plain model, FD_RTOL, on two layers of large |dF/dT| at a
    step that moves no index and no keep flag (exact_fd_step); the
    gradient step's time."""
    kernels = ALL_KERNELS + EXACT_KERNELS
    for k in kernels:
        k.launches = 0
    leaves = [grad_leaves(m, T0, q0) for T0, q0 in requests]
    grads = [grad_step(m, T, q) for T, q in leaves]
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in kernels}
    want = {k.__name__: 3 if k in EXACT_KERNELS else 0 for k in kernels}
    check(launches == want, f"{label}: launches in 3 steps {launches}, "
          f"the path asks {want}")
    m.use_kernel = False
    plain = [grad_step(m, T, q) for T, q in leaves]
    m.use_kernel = True
    err = {"T": 0.0, "q": 0.0}
    for (gT, gq), (pT, pq) in zip(grads, plain):
        check(bool(torch.isfinite(gT).all()) and bool(torch.isfinite(
            gq).all()) and float(gT.abs().max()) > 0,
            f"{label}: gradient not finite or zero")
        err["T"] = max(err["T"], max_rel(gT, pT))
        err["q"] = max(err["q"], max_rel(gq, pq))
    check(max(err.values()) < GRAD_TOL, f"{label}: gradient kernel path vs "
          f"plain path {err} >= {GRAD_TOL}")
    m64 = TransitModel(m.cfg, dtype=torch.float64, device=m.device,
                       use_kernel=False, table=m.table)
    T0, q0 = (np.asarray(a, dtype=np.float64) for a in requests[0])
    gT = grads[0][0].double().cpu().numpy()
    fd, jumps = {}, []
    for layer in np.argsort(-np.abs(gT))[:EXACT_FD_LAYERS].tolist():
        if len(fd) == 2:
            break
        h = exact_fd_step(m64, T0, layer)
        if h is None:
            jumps.append(layer)
            continue
        f = []
        with torch.no_grad():
            for sign in (1.0, -1.0):
                T = T0.copy()
                T[layer] += sign * h
                f.append(float(m64.forward(T, q0).sum()))
        d = (f[0] - f[1]) / (2.0 * h)
        fd[layer] = {"fd": d, "grad": float(gT[layer]), "step": h,
                     "rel": abs(d - gT[layer]) / abs(d)}
        check(fd[layer]["rel"] < FD_RTOL, f"{label}: layer {layer} central "
              f"difference {d:.6e} vs gradient {gT[layer]:.6e}")
    check(len(fd) == 2, f"{label}: of the {EXACT_FD_LAYERS} layers of "
          f"largest |dF/dT|, {len(jumps)} have an index or keep flag within "
          f"{EXACT_FD_MIN} K of their T")
    del m64
    T, q = leaves[0]
    return {"launches": launches, "vs_plain_path": err, "fd": fd,
            "fd_layers_at_a_jump": jumps,
            "forward_backward_ms": cuda_ms(lambda: grad_step(m, T, q))}


def exact_phases(dev, profile: str | None = None, card: str = "") -> dict:
    """The exact path's phases (exact_model_setup, exact_kernels_vs_plain,
    exact_path, exact_path_checks, exact_path_times, exact_path_grad) on
    exact_config(): the model's profile table built on the card, three
    forward requests at the file's T and +-50 K, every check raising on
    a miss; with ``profile`` (a trace path) also profile_exact and
    profile_grad_exact, torch.profiler passes of the forward and the
    gradient step (traces ``<stem>_exact`` and ``<stem>_grad_exact``).
    Returns what the result line reads."""
    t0 = time.perf_counter()
    cfg_e = exact_config()
    t_tab = time.perf_counter()
    table = exact_table(cfg_e, dev)
    table_s = time.perf_counter() - t_tab
    hje = TransitModel(cfg_e, dtype=torch.float32, device=dev, table=table)
    check(hje.mode == "exact" and (hje.wns.n, hje.atm.nlayers) == HJ_SHAPE
          and hje.owns.o == cfg_e.wnosamp, f"exact grid {hje.wns.n} x "
          f"{hje.atm.nlayers} x {hje.owns.o}")
    grp_e, st_e = exact_groups(hje)
    pairs_e = scatter_pairs(grp_e["g_k"], grp_e["g_idop"], grp_e["ilor"],
                            st_e)
    torch.cuda.synchronize()
    nprof = int(np.unique(table.base).shape[0])
    phase("exact_model_setup", t0,
          f"profile table {table_s:.2f} s on the card: {nprof} profiles, "
          f"{table.flat.nbytes / 1e6:.1f} MB ({table.flat.shape[0]} "
          f"values); {hje.plan.n_lines} lines in {hje.plan.n_groups} "
          f"groups; {int(grp_e['keep'].sum())} kept (layer, group) of "
          f"{grp_e['keep'].numel()}; {pairs_e} live (layer, kept group, j) "
          f"pairs (host count)")
    t0 = time.perf_counter()
    T0 = np.asarray(hje.atm.temp, dtype=np.float64)
    q0 = np.asarray(hje.atm.q, dtype=np.float64)
    requests = [(T0, q0), (T0 + 50.0, q0), (T0 - 50.0, q0)]
    g_e = line_cotangent(hje, T0, q0)
    err_e = exact_vs_plain(hje, g_e, "exact")
    phase("exact_kernels_vs_plain", t0, "profile_scatter and its backward "
          "against their plain versions at the file's T and +-50 K and on "
          "the synthetic case (tiles wider than the shared segment), pair "
          "counters equal to the host counts, the backward bit for bit: " +
          json.dumps(err_e))
    t0 = time.perf_counter()
    specs_e, launches_e = run_requests(hje, requests,
                                       ALL_KERNELS + EXACT_KERNELS)
    phase("exact_path", t0, f"3 forward requests, kernel launches "
          f"{launches_e}, per forward {per_forward(launches_e)}")
    want_e = {k.__name__: 3 if k is profile_scatter else 0
              for k in ALL_KERNELS + EXACT_KERNELS}
    check(launches_e == want_e, f"exact path: launches {launches_e}, the "
          f"path asks {want_e}")
    t0 = time.perf_counter()
    spec_rel_e = check_spectra(hje, specs_e, requests, "exact")
    ce_med, ce_p90, ce_max = c_median(hje, specs_e[0], with_max=True)
    check(ce_med < EXACT_C_MEDIAN_TOL, f"exact median vs reference C "
          f"{ce_med:.3e} >= {EXACT_C_MEDIAN_TOL}")
    t_cpu = time.perf_counter()
    table_cpu = exact_table(cfg_e, "cpu")
    cpu_s = time.perf_counter() - t_cpu
    ulp_max, ulp_n = table_ulps(table, table_cpu)
    check(ulp_max <= 1, f"profile table card vs CPU: {ulp_max} ulp")
    del table_cpu
    phase("exact_path_checks", t0,
          f"vs plain path max_rel {spec_rel_e:.3e}; vs reference C median "
          f"{ce_med:.4e} (p90 {ce_p90:.4e}, max {ce_max:.4e}; bound "
          f"{EXACT_C_MEDIAN_TOL}); profile table card vs CPU ({cpu_s:.2f} "
          f"s): {ulp_n} of {table.flat.shape[0]} values differ, max "
          f"{ulp_max} ulp")
    t0 = time.perf_counter()
    ms_fwd_e = cuda_ms(lambda: hje.forward(T0, q0))
    sargs = (grp_e["g_k"], grp_e["g_idop"], grp_e["ilor"], st_e)
    keep_e = grp_e["keep"]
    bounds_e = exact_bounds(grp_e, st_e)
    times_e = {
        "profile_scatter": {
            "ms": cuda_ms(lambda: profile_scatter(*sargs)),
            "plain_ms": cuda_ms(lambda: profile_scatter_plain(*sargs),
                                runs=1)},
        "profile_scatter_backward": {
            "ms": cuda_ms(lambda: profile_scatter_backward(
                g_e, keep_e, *sargs[1:])),
            "plain_ms": cuda_ms(lambda: profile_scatter_plain_vjp(
                g_e, keep_e, *sargs[1:]), runs=1)}}
    for k, b in bounds_e.items():
        times_e[k].update(b)
    phase("exact_path_times", t0, f"forward {ms_fwd_e:.3f} ms; " +
          json.dumps(times_e))
    t0 = time.perf_counter()
    grad_e = exact_grad_phase(hje, requests, "exact grad")
    phase("exact_path_grad", t0, f"3 gradient steps; forward+backward "
          f"{grad_e['forward_backward_ms']:.3f} ms; backward kernel "
          f"{times_e['profile_scatter_backward']['ms']:.4f} ms (bound "
          f"{times_e['profile_scatter_backward']['bound_ms']:.4f} ms); " +
          json.dumps(grad_e))
    t0 = time.perf_counter()
    graph_e = graph_phase(hje, requests, "exact", atomics=True,
                          profile=profile)
    phase("graph_exact", t0, graph_text(graph_e, card) + " (float32 "
          "atomics in the co-add sums: within GRAPH_TOL)")
    prof = {}
    if profile:
        trace = Path(profile)
        t0 = time.perf_counter()
        prof["forward"] = profile_forward(hje, T0, q0, ms_fwd_e, str(
            trace.with_name(f"{trace.stem}_exact{trace.suffix}")), "exact")
        phase("profile_exact", t0)
        t0 = time.perf_counter()
        leaves = grad_leaves(hje, T0, q0)
        prof["grad"] = profile_step(
            lambda: grad_step(hje, *leaves), grad_e["forward_backward_ms"],
            str(trace.with_name(f"{trace.stem}_grad_exact{trace.suffix}")),
            "exact grad")
        phase("profile_grad_exact", t0)
    return {"err": err_e, "launches": launches_e, "times": times_e,
            "grad": grad_e, "forward_ms": ms_fwd_e, "pairs": pairs_e,
            "profile": prof, "graph": graph_e, "model": hje}


def grid_model(m: TransitModel):
    """The exact model ``m`` with the opacity grid's temperatures
    (GRID_T) in its configuration: the grid builders read them there."""
    m.cfg.tlow, m.cfg.thigh, m.cfg.tempdelt = GRID_T
    return m


def reset_counts(kernels):
    for k in kernels:
        k.launches = 0


def read_counts(kernels) -> dict:
    torch.cuda.synchronize()
    return {k.__name__: k.launches for k in kernels}


def grid_exact_vs_plain(m: TransitModel, cells) -> dict:
    """Every chunk of the exact build (grid.exact_chunks): the
    per-molecule profile_scatter launch against its plain version on the
    same inputs (max|a-b| / (|a| + 1e-6 max|a|) < KERNEL_REL_TOL) and its
    pair counter against the host count (lbl.scatter_pairs)."""
    res = {"max_rel": 0.0, "max_abs": 0.0, "pairs": 0, "chunks": 0,
           "cells": 0}
    for sl, grp, s in grid.exact_chunks(m, cells):
        args = (grp["g_k"], grp["g_idop"], grp["ilor"], s)
        stats = torch.zeros(1, dtype=torch.int64, device=m.device)
        got = profile_scatter(*args, stats=stats)
        want = profile_scatter_plain(*args)
        torch.cuda.synchronize()
        check(got.shape == (sl.stop - sl.start, s.nm, s.n_coarse) and
              bool(torch.isfinite(got).all()) and float(want.max()) > 0,
              f"grid exact cells {sl}: per-molecule profile_scatter output "
              f"{tuple(got.shape)} not finite, or plain zero")
        err = rel_err(want, got)
        check(err < KERNEL_REL_TOL, f"grid exact cells {sl}: per-molecule "
              f"profile_scatter vs plain {err:.3e} >= {KERNEL_REL_TOL}")
        host = scatter_pairs(*args)
        check(int(stats[0]) == host, f"grid exact cells {sl}: pair counter "
              f"{int(stats[0])} != host count {host}")
        res["max_rel"] = max(res["max_rel"], err)
        res["max_abs"] = max(res["max_abs"],
                             float((got - want).abs().max()))
        res["pairs"] += host
        res["chunks"] += 1
        res["cells"] += sl.stop - sl.start
    return res


def grid_exact_times(m: TransitModel, cells) -> dict:
    """The per-molecule profile_scatter launch of the exact build's first
    chunk: its time, its plain version's, its bound (exact_bounds, the
    (cells, nm, n_coarse) output) and the chunk's cells."""
    sl, grp, s = next(grid.exact_chunks(m, cells))
    args = (grp["g_k"], grp["g_idop"], grp["ilor"], s)
    b = exact_bounds(grp, s)["profile_scatter"]
    return {"cells": sl.stop - sl.start,
            "ms": cuda_ms(lambda: profile_scatter(*args)),
            "plain_ms": cuda_ms(lambda: profile_scatter_plain(*args),
                                runs=1), **b}


def grid_fast_vs_plain(m: TransitModel, cells, plans) -> dict:
    """Per molecule of the fast build: layer_kmax on every cell against
    its plain version bit for bit, and each launch of the banded function
    (banded.launch_units) on GRID_FAST_CELLS cells of its band against its
    plain version (KERNEL_REL_TOL), at unit density."""
    res = {"kmax_max_abs": 0.0}
    for mp in plans:
        tab, temps, kw = grid.fast_tables(m, cells, mp)
        a = banded.band_kmax(mp.devs[0], temps, tab["coef0"], True)
        b = banded.band_kmax(mp.devs[0], temps, tab["coef0"], False)
        check(torch.equal(a, b), f"grid fast molecule {mp.m}: layer_kmax "
              f"vs plain max_abs {float((a - b).abs().max())!r}")
        for i, part, unit in banded.launch_units(mp.bplan, mp.devs,
                                                 mp.index):
            rows = mp.index["rows"][i]
            n = rows.shape[0]
            r = rows[torch.linspace(0, n - 1, GRID_FAST_CELLS,
                                    device=rows.device).long().unique()]
            sel = r.long()
            got = torch.zeros((temps.shape[0], m.wns.n), device=m.device)
            want = torch.zeros_like(got)
            launch_kernel(tab, temps, kw, part, unit, r, got)
            launch_plain(tab, temps, kw, part, unit, sel, want)
            got, want = got[sel], want[sel]
            check(bool(torch.isfinite(got).all()),
                  f"grid fast molecule {mp.m} {part}: kernel not finite")
            err = rel_err(want, got)
            check(err < KERNEL_REL_TOL, f"grid fast molecule {mp.m} band "
                  f"{i} {part}: kernel vs plain {err:.3e} >= "
                  f"{KERNEL_REL_TOL}")
            e = res.setdefault(kernel_name(part), {"max_rel": 0.0,
                                                   "max_abs": 0.0,
                                                   "launches": 0})
            e["max_rel"] = max(e["max_rel"], err)
            e["max_abs"] = max(e["max_abs"], float((got - want).abs().max()))
            e["launches"] += 1
    return res


def fast_build_launches(plans) -> dict:
    """The launches the fast build's plans ask: per molecule one
    layer_kmax, one line-tile launch per near or stride-1 class and one
    shell launch per band with decimated shells."""
    want = {"layer_kmax": len(plans), "line_tile_extinction": 0,
            "shell_tile_extinction": 0}
    for mp in plans:
        for _, part, _ in banded.launch_units(mp.bplan, mp.devs, mp.index):
            want[kernel_name(part)] += 1
    return want


def grid_consistency(m: TransitModel, cells) -> float:
    """At ethresh 1e-30: the exact grid's rows of the GRID_LAYERS' cells
    (every grid temperature) times each cell's densities against the
    exact model's line extinction of those cells as layers (both through
    the kernels); returns max|a-b| / max|b|."""
    nt = cells.temps.shape[0]
    idx = np.concatenate([np.arange(r * nt, (r + 1) * nt)
                          for r in GRID_LAYERS])
    sub = dataclasses.replace(cells, tt=cells.tt[idx], dd=cells.dd[:, idx],
                              zz=cells.zz[:, idx])
    eth = m.cfg.ethreshold
    m.cfg.ethreshold = 1e-30
    try:
        with torch.no_grad():
            (_, grp, s), = grid.exact_chunks(m, sub)
            rows = profile_scatter_permol(grp, s)
            ids = list(m.mol.ids)
            dens = m._t(sub.dd)
            mol = [ids.index(int(i)) for i in cells.molID]
            coll = (rows * dens[mol].T[:, :, None]).sum(dim=1)
            direct = m.line_extinction(m._t(sub.tt), dens, m._t(sub.zz))
    finally:
        m.cfg.ethreshold = eth
    torch.cuda.synchronize()
    check(bool(torch.isfinite(coll).all()) and float(direct.max()) > 0,
          "grid consistency: not finite, or the line extinction zero")
    return max_rel(coll.double(), direct.double())


def cli_mode_b(workdir: Path) -> dict:
    """transit_tpu_torch.cli.main on the card (float32) in the fixture's
    opacity modes (tests/test_opacity_grid.py:141-200): the two-step path
    (--justOpacity, then a grid-mode run) and mode (b) (an absent
    opacityfile built, written, and serving the spectrum in the same
    run), then a grid-mode run on mode (b)'s file, whose spectrum must
    equal mode (b)'s byte for byte; the two grids within
    GRID_BUILDS_TOL of the max (float32 atomics: their bytes may
    differ)."""
    common = [
        "--atm", f"{FIX}/test.atm", "--linedb", f"{FIX}/test.tli",
        "--csfile", f"{FIX}/test_cia.dat", "--molfile",
        f"{FIX}/molecules.dat", "--wnlow", "2000", "--wnhigh", "2100",
        "--wndelt", "1.0", "--wnosamp", "216", "--wnfct", "1.0", "--ndop",
        "15", "--nlor", "15", "--dmin", "1e-3", "--dmax", "0.25", "--lmin",
        "1e-4", "--lmax", "10.0", "--nwidth", "20", "--ethresh", "1e-8",
        "--solution", "eclipse", "--toomuch", "1e30", "--raygrid",
        "0 20 40 60 80", "--tlow", "1000", "--thigh", "2000", "--tempdelt",
        "100", "--verb", "0"]
    f = {k: str(workdir / k) for k in ("two.bin", "two.dat", "b.bin",
                                       "b.dat", "c.dat")}
    kernels = ALL_KERNELS + EXACT_KERNELS
    reset_counts(kernels)
    check(cli.main(common + ["--opacityfile", f["two.bin"],
                             "--justOpacity"]) == 0, "cli: --justOpacity")
    check(cli.main(common + ["--opacityfile", f["two.bin"], "--outspec",
                             f["two.dat"]]) == 0, "cli: grid-mode run")
    check(cli.main(common + ["--opacityfile", f["b.bin"], "--outspec",
                             f["b.dat"]]) == 0, "cli: mode (b)")
    launches = read_counts(kernels)
    check(cli.main(common + ["--opacityfile", f["b.bin"], "--outspec",
                             f["c.dat"]]) == 0, "cli: mode (c) on (b)'s file")
    read = {k: Path(v).read_bytes() for k, v in f.items()}
    check(read["b.dat"] == read["c.dat"], "cli: mode (b)'s spectrum differs "
          "from a grid-mode run on the file it wrote")
    a = grid.read_opacity_grid(f["two.bin"]).grid
    b = grid.read_opacity_grid(f["b.bin"]).grid
    err = float(np.abs(a - b).max() / np.abs(a).max())
    check(a.shape == (20, 11, 1, 101) and np.abs(a).max() > 0 and
          err < GRID_BUILDS_TOL, f"cli: the two builds' grids {a.shape}: "
          f"{err:.3e} >= {GRID_BUILDS_TOL}")
    want = {k.__name__: 2 if k.__name__ == "profile_scatter" else 0
            for k in kernels}
    check(launches == want, f"cli: launches of two builds and two grid-mode "
          f"runs {launches}, the path asks {want}")
    spec = np.loadtxt(f["b.dat"])
    check(spec.shape == (101, 2) and np.all(np.isfinite(spec[:, 1])) and
          np.all(spec[:, 1] > 0), "cli: mode (b) spectrum")
    return {"grid_max_rel": err, "grid_bytes_equal":
            read["two.bin"] == read["b.bin"],
            "spectrum_bytes_equal": read["two.dat"] == read["b.dat"],
            "launches": launches}


def grid_phases(m: TransitModel, card: str,
                profile: str | None = None) -> dict:
    """The opacity grid's phases on hj_ref.cfg's exact model ``m`` with
    bench.py's temperature grid (GRID_T: 100 layers x 25 temperatures x 4
    molecules x 19001 wavenumbers):
      - grid_build_exact: every chunk's per-molecule profile_scatter
        against its plain version and its pair counter; the build timed,
        its launches counted;
      - grid_build_fast: the plans (host), layer_kmax bit for bit and a
        few cells of each band's launches against their plain versions;
        the build timed, its launches against the plans';
      - grid_consistency: the exact grid against the exact model's line
        extinction (ethresh 1e-30), and the L1 gap between the grids;
      - grid_path: the exact grid written and read back by a grid-mode
        model (mode c): forward, the gradient step and compute on the
        card, grid_extinction against the float64 CPU version, the
        gradient against the float64 model's, the spectrum against the
        line-by-line one (and on and between the grid's temperatures:
        grid_vs_lbl_nodes), times (and with ``profile`` a torch.profiler
        pass of the forward and the gradient step, and of each build:
        traces ``<stem>_grid``, ``_grad_grid``, ``_grid_exact``,
        ``_grid_fast``);
      - cli_mode_b: the CLI's opacity modes on the fixture.
    Every check raises on a miss.  Returns what the result line reads."""
    grid_model(m)
    kernels = ALL_KERNELS + EXACT_KERNELS
    cells = grid.grid_cells(m)
    L, T, M, W = GRID_SHAPE
    out = {}

    t0 = time.perf_counter()
    vs = grid_exact_vs_plain(m, cells)
    times = grid_exact_times(m, cells)
    reset_counts(kernels)
    t1 = time.perf_counter()
    og = grid.build_opacity_grid(m)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t1
    launches = read_counts(kernels)
    want = {k.__name__: vs["chunks"] if k.__name__ == "profile_scatter"
            else 0 for k in kernels}
    check(launches == want, f"grid exact build: launches {launches}, the "
          f"build asks {want}")
    check(og.grid.shape == GRID_SHAPE and bool(np.isfinite(og.grid).all())
          and og.grid.max() > 0, f"grid exact build {og.grid.shape}")
    check(og.molID.tolist() == [int(m.mol.ids[i]) for i in
                                dict.fromkeys(m.iso.imol.tolist())],
          f"grid molID {og.molID.tolist()}")
    out["exact"] = {"seconds": secs, "cells_per_s": L * T * W / secs,
                    "launches": launches["profile_scatter"], "vs_plain": vs,
                    "times": times}
    phase("grid_build_exact", t0,
          f"{L} x {T} x {M} x {W} in {secs:.3f} s: {L * T * W / secs:.6e} "
          f"layer*temp*wn cells/s ({card}); profile_scatter (per molecule) "
          f"{launches['profile_scatter']} launches, against plain on every "
          f"cell: " + json.dumps(vs) + "; first chunk's launch: " +
          json.dumps(times))
    if profile:
        t0 = time.perf_counter()
        trace = Path(profile)
        out["exact"]["profile"] = profile_step(
            lambda: grid.build_opacity_grid(m), secs * 1e3,
            str(trace.with_name(f"{trace.stem}_grid_exact{trace.suffix}")),
            "grid exact build")
        phase("profile_grid_exact", t0)

    t0 = time.perf_counter()
    plans = grid.fast_plans(m, cells)
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0
    vs_f = grid_fast_vs_plain(m, cells, plans)
    reset_counts(kernels)
    t1 = time.perf_counter()
    ogf = grid.build_opacity_grid_fast(m, plans=plans)
    torch.cuda.synchronize()
    secs_f = time.perf_counter() - t1
    launches_f = read_counts(kernels)
    want_f = {k.__name__: 0 for k in kernels}
    want_f.update(fast_build_launches(plans))
    check(launches_f == want_f, f"grid fast build: launches {launches_f}, "
          f"the plans ask {want_f}")
    check(ogf.grid.shape == GRID_SHAPE and bool(np.isfinite(ogf.grid).all())
          and ogf.grid.max() > 0, f"grid fast build {ogf.grid.shape}")
    decimated = sorted({s for mp in plans for far in mp.bplan.far_plans or ()
                        if far for *_, s in far if s > 1})
    out["fast"] = {"seconds": secs_f, "plan_seconds": plan_s,
                   "cells_per_s": L * T * W / secs_f,
                   "cells_per_s_with_plans": L * T * W / (secs_f + plan_s),
                   "launches": launches_f, "vs_plain": vs_f,
                   "bands": [len(mp.bplan.slices) for mp in plans],
                   "decimated_strides": decimated}
    phase("grid_build_fast", t0,
          f"plans {plan_s:.3f} s (host), build {secs_f:.3f} s: "
          f"{L * T * W / secs_f:.6e} layer*temp*wn cells/s "
          f"({L * T * W / (secs_f + plan_s):.6e} with the plans; {card}); "
          f"launches {launches_f}; bands per molecule "
          f"{out['fast']['bands']}, decimated shells {decimated}; against "
          "plain: " + json.dumps(vs_f))
    if profile:
        t0 = time.perf_counter()
        trace = Path(profile)
        out["fast"]["profile"] = profile_step(
            lambda: grid.build_opacity_grid_fast(m, plans=plans),
            secs_f * 1e3,
            str(trace.with_name(f"{trace.stem}_grid_fast{trace.suffix}")),
            "grid fast build")
        phase("profile_grid_fast", t0)

    t0 = time.perf_counter()
    cons = grid_consistency(m, cells)
    check(cons < GRID_CONSISTENCY_TOL, f"grid consistency {cons:.3e} >= "
          f"{GRID_CONSISTENCY_TOL}")
    l1 = float(np.abs(ogf.grid - og.grid).sum() / np.abs(og.grid).sum())
    del ogf
    out["consistency"], out["l1_fast_vs_exact"] = cons, l1
    phase("grid_consistency", t0,
          f"exact grid x densities vs the exact model's line extinction at "
          f"ethresh 1e-30 on layers {list(GRID_LAYERS)} x {T} temperatures: "
          f"max_rel {cons:.3e} (bound {GRID_CONSISTENCY_TOL}); L1 gap fast "
          f"vs exact grid {l1:.6e} (for the record)")

    t0 = time.perf_counter()
    workdir = ROOT / "build" / "grid"
    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    try:
        path = workdir / "hj_grid.bin"
        grid.write_opacity_grid(str(path), og)
        cfg_g = exact_config()
        cfg_g.tlow, cfg_g.thigh, cfg_g.tempdelt = GRID_T
        cfg_g.opacityfile = str(path)
        mg = TransitModel(cfg_g, dtype=torch.float32, device=m.device)
        check(mg.ogrid is not None and mg.tli is None and mg.plan is None,
              "grid path: the model read a line list")
        T0 = np.asarray(mg.atm.temp, dtype=np.float64)
        q0 = np.asarray(mg.atm.q, dtype=np.float64)
        requests = [(T0, q0), (T0 + 50.0, q0), (T0 - 50.0, q0)]
        specs, launches_g = run_requests(mg, requests, kernels)
        check(launches_g == {k.__name__: 0 for k in kernels},
              f"grid path: line kernels launched {launches_g}")
        for sp in specs:
            check(sp.shape == (W,) and bool(torch.isfinite(sp).all()) and
                  float(sp.min()) > 0, "grid path: spectrum")
        res = mg.compute()
        check(torch.equal(res.spectrum, specs[0]) or
              max_rel(res.spectrum, specs[0]) < 1e-6,
              "grid path: compute differs from forward")
        Tc = mg._t(T0) * mg.atm.tfct
        a = grid.grid_extinction(mg._ogrid_temp_t, mg._ogrid_t,
                                 mg._grid_mol_t, Tc, mg._t(mg.atm.d))
        b = grid.grid_extinction(
            torch.as_tensor(og.temp), torch.from_numpy(og.grid),
            mg._grid_mol_t.cpu(), torch.as_tensor(T0 * mg.atm.tfct),
            torch.as_tensor(np.asarray(mg.atm.d, dtype=np.float64)))
        ext_err = rel_err(b, a.double().cpu())
        check(ext_err < KERNEL_REL_TOL, f"grid path: grid_extinction vs "
              f"float64 CPU {ext_err:.3e} >= {KERNEL_REL_TOL}")
        leaves = grad_leaves(mg, T0, q0)
        g32 = grad_step(mg, *leaves)
        mg64 = TransitModel(cfg_g, dtype=torch.float64, device=m.device)
        g64 = grad_step(mg64, *(torch.tensor(x, dtype=torch.float64,
                                             device=m.device,
                                             requires_grad=True)
                                for x in (T0, q0)))
        del mg64
        gerr = {"T": max_rel(g32[0].double(), g64[0]),
                "q": max_rel(g32[1].double(), g64[1])}
        check(all(bool(torch.isfinite(g).all()) for g in g32) and
              float(g32[0].abs().max()) > 0 and max(gerr.values()) < GRAD_TOL,
              f"grid path: gradient vs float64 {gerr} >= {GRAD_TOL}")
        lbl_spec = m.forward(T0, q0)
        ratio = (specs[0].double() / lbl_spec.double() - 1.0).abs()
        iso = grid_vs_lbl_nodes(mg, m, og.temp, T0, q0)
        ms_fwd = cuda_ms(lambda: mg.forward(T0, q0))
        ms_grad = cuda_ms(lambda: grad_step(mg, *leaves))
        out["path"] = {"forward_ms": ms_fwd, "gradient_ms": ms_grad,
                       "grid_extinction_vs_float64_cpu": ext_err,
                       "gradient_vs_float64": gerr,
                       "median_vs_lbl": float(ratio.median()),
                       "max_vs_lbl": float(ratio.max()),
                       "nodes_vs_lbl": iso}
        t1 = time.perf_counter()
        out["graph"] = graph_phase(mg, requests, "grid", atomics=True,
                                   profile=profile)
        phase("graph_grid", t1, graph_text(out["graph"], card))
        if profile:
            trace = Path(profile)
            out["path"]["profile_forward"] = profile_forward(
                mg, T0, q0, ms_fwd, str(trace.with_name(
                    f"{trace.stem}_grid{trace.suffix}")), "grid")
            out["path"]["profile_grad"] = profile_step(
                lambda: grad_step(mg, *leaves), ms_grad,
                str(trace.with_name(f"{trace.stem}_grad_grid"
                                    f"{trace.suffix}")), "grid grad")
        del mg
        grid_spec = specs[0]
        phase("grid_path", t0,
              f"forward {ms_fwd:.3f} ms, gradient step {ms_grad:.3f} ms "
              f"({card}); no line kernel launched; grid_extinction vs "
              f"float64 CPU {ext_err:.3e}; gradient vs float64 {gerr}; "
              f"median |grid / line-by-line spectrum - 1| "
              f"{out['path']['median_vs_lbl']:.4e} (max "
              f"{out['path']['max_vs_lbl']:.4e}; for the record); "
              f"on and between the grid's temperatures: {json.dumps(iso)}")

        t0 = time.perf_counter()
        out["multihost"] = multihost_grid(cfg_g, grid_spec, T0, q0,
                                          m.device, kernels)
        phase("multihost_grid", t0, f"{MH_PROCS} grid-mode band models, "
              "each reading its wavenumber columns of the file: "
              + json.dumps(out["multihost"]))

        t0 = time.perf_counter()
        out["cli"] = cli_mode_b(workdir)
        phase("cli_mode_b", t0, json.dumps(out["cli"]))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return out


def multihost_grid(cfg_g, full_spec, T0, q0, device, kernels) -> dict:
    """Grid-mode band models (multihost.build_band_model, an even split
    of the grid's wavenumbers into MH_PROCS bands): each reads only its
    columns of the grid file and launches no line kernel; the
    concatenated band spectra against the full grid model's
    (BANDED_VS_UNBANDED_TOL)."""
    parts, blocks = [], []
    reset_counts(kernels)
    for pid in range(MH_PROCS):
        bm, blk, _ = multihost.build_band_model(cfg_g, MH_PROCS, pid,
                                                dtype=torch.float32,
                                                device=device)
        check(bm.ogrid is not None and bm.tli is None and
              bm.ogrid.grid.shape[-1] == blk[1] - blk[0],
              f"multihost grid: band {blk} read {bm.ogrid.grid.shape}")
        parts.append(bm.forward(T0, q0))
        blocks.append(list(blk))
        del bm
    launches = read_counts(kernels)
    check(not any(launches.values()),
          f"multihost grid: line kernels launched {launches}")
    got = torch.cat(parts)
    vs = float(((got - full_spec).abs() / full_spec.abs()).max())
    check(got.shape == full_spec.shape and vs <= BANDED_VS_UNBANDED_TOL,
          f"multihost grid: bands vs full grid model {vs:.3e}")
    return {"blocks": blocks, "vs_full": vs}


def grid_vs_lbl_nodes(mg: TransitModel, m: TransitModel, temps, T0,
                      q0) -> dict:
    """Grid mode (the model ``mg``) against line-by-line (the exact model
    ``m``) where the interpolation in T is exact, beside where it is
    furthest from the line strengths' exponential change: the line
    extinction of an isothermal profile on a grid temperature
    (GRID_ISO_NODE) and half-way to the next, max |grid - lbl| / max
    lbl (an isothermal atmosphere's eclipse flux is its Planck function
    whatever the opacity, so its extinction is compared); and the
    spectrum of the file profile with every layer moved to its nearest
    grid temperature, and half-way to the next one, median and max
    |grid / lbl - 1|.  On a node only the line cut differs: each grid
    molecule's cells are cut at their own kmax."""
    out = {}
    k, step = GRID_ISO_NODE, float(temps[1] - temps[0])
    with torch.no_grad():
        for name, t in (("on_node", float(temps[k])),
                        ("mid_node", float(temps[k]) + 0.5 * step)):
            ext = []
            for mm in (mg, m):
                T = mm._t(np.full(mm.atm.nlayers, t / mm.atm.tfct))
                _, _, dens = mm._profiles(T, q0)
                ext.append(mm.line_extinction(T * mm.atm.tfct, dens,
                                              mm.partition(T)).double())
            out[f"isothermal_{name}"] = {"T": t, "ext_max_over_max": float(
                (ext[0] - ext[1]).abs().max() / ext[1].abs().max())}
        node = (temps[0] + step * np.round((T0 * mg.atm.tfct - temps[0]) /
                                           step)) / mg.atm.tfct
        for name, T in (("snapped_on_node", node),
                        ("snapped_mid_node",
                         node + 0.5 * step / mg.atm.tfct)):
            r = (mg.forward(T, q0).double() / m.forward(T, q0).double() -
                 1.0).abs()
            out[name] = {"median": float(r.median()), "max": float(r.max())}
    for v in out.values():
        check(all(np.isfinite(x) for x in v.values()),
              f"grid vs lbl on the nodes: not finite {out}")
    on = out["isothermal_on_node"]["ext_max_over_max"]
    check(on < GRID_CONSISTENCY_TOL, f"grid vs lbl: the line extinction of "
          f"an isothermal profile on a grid temperature differs by {on:.3e}"
          f" of its max (bound {GRID_CONSISTENCY_TOL})")
    return out


def grid_keys(gr: dict) -> dict:
    """The profile_scatter entry's keys of the exact grid build: the
    per-molecule launches of one build, their error against the plain
    version, and the first chunk's launch timed beside its bound."""
    t = gr["exact"]["times"]
    return {"launches_grid_build": gr["exact"]["launches"],
            "max_abs_err_grid_build": gr["exact"]["vs_plain"]["max_abs"],
            "max_rel_vs_plain_grid_build": gr["exact"]["vs_plain"][
                "max_rel"],
            "grid_build_launch": {k: t[k] for k in (
                "cells", "ms", "plain_ms", "bound_ms", "bound_by", "pairs",
                "table_elements")}}


def merge_errors(acc: dict, res: dict) -> dict:
    """Fold one shard's launch-against-plain record ({kernel: {"max_rel",
    "max_abs", ...: x, "launches": n}}, nested dicts alike) into acc:
    the max of each error, the sum of the launches."""
    for k, v in res.items():
        if isinstance(v, dict):
            merge_errors(acc.setdefault(k, {}), v)
        elif k == "launches":
            acc[k] = acc.get(k, 0) + v
        else:
            acc[k] = max(acc.get(k, 0.0), v)
    return acc


def sharded_phase(m: TransitModel, T0, q0, label: str,
                  profile: str | None = None) -> dict:
    """The banded model ``m`` in SHARDS line-balanced wavenumber shards on
    the card (parallel.sharded, one process): every shard's launches
    against their plain versions (layer_kmax bit for bit on the model's
    whole line list, each line-tile and shell launch, each backward launch
    on the main path's cotangent); one sharded forward (each shard through
    step.local, then assembled) with the launch counts set to 0 just
    before and read just after, against the launches the shards' plans
    ask and against the unsharded forward (BANDED_VS_UNBANDED_TOL); the
    gradient of its sum against the unsharded gradient (GRAD_TOL); the
    shards' step times beside the unsharded forward's; the compiled step
    (``step(T, q)``: one CUDA graph of every shard's local and the
    assembly, forward and backward) against the eager local assembly on
    three requests (graph_phase).  With ``profile`` (a trace path), a
    torch.profiler pass of shard 0's step and of the whole sharded step
    (traces ``_shard`` and ``_sharded`` beside it)."""
    step = make_sharded_forward(m, nshard=SHARDS)
    check(isinstance(step, GraphedShardedStep),
          f"{label}: make_sharded_forward on the card made a "
          f"{type(step).__name__}")
    views = [step._view(s) for s in range(SHARDS)]
    g = line_cotangent(m, T0, q0)
    kmax_err, fwd, bwd = 0.0, {}, {}
    want = {k.__name__: 0 for k in ALL_KERNELS}
    for s, v in enumerate(views):
        name = f"{label} shard {s}"
        check(v[1][0]["all_wavn"] is m.bdev[0]["all_wavn"],
              f"{name}: the kmax scan reads another line list")
        kmax_err = max(kmax_err, kmax_vs_plain(m, name, v))
        merge_errors(fwd, banded_vs_plain(m, name, v))
        merge_errors(bwd, backward_vs_plain(m, g, name, v))
        want["layer_kmax"] += 1
        for _, part, _ in banded.launch_units(*v):
            want[kernel_name(part)] += 1
        for part, *_ in backward_launches(m, v):
            want[bwd_name(part)] += 1
    reset_counts(ALL_KERNELS)
    parts = [step.local(s, T0, q0) for s in range(SHARDS)]
    spec = step.assemble(parts)
    launches = read_counts(ALL_KERNELS)
    check(launches == {k: want[k] if "backward" not in k else 0
                       for k in want},
          f"{label}: launches {launches}, the shards' plans ask {want}")
    ref = m.forward(T0, q0)
    check(all(p.shape == (step.span,) for p in parts) and
          spec.shape == ref.shape and bool(torch.isfinite(spec).all()),
          f"{label}: sharded spectrum {tuple(spec.shape)}")
    vs = float(((spec - ref).abs() / ref.abs()).max())
    check(vs <= BANDED_VS_UNBANDED_TOL, f"{label}: sharded vs unsharded "
          f"{vs:.3e} > {BANDED_VS_UNBANDED_TOL}")
    T, q = grad_leaves(m, T0, q0)
    reset_counts(ALL_KERNELS)
    gs = torch.autograd.grad(step.assemble(
        [step.local(s, T, q) for s in range(SHARDS)]).sum(), (T, q))
    launches_grad = read_counts(ALL_KERNELS)
    for k in ("line_tile_backward", "shell_tile_backward", "layer_kmax"):
        check(launches_grad[k] == want[k], f"{label}: gradient launched "
              f"{k} {launches_grad[k]} times, the shards ask {want[k]}")
    g1 = grad_step(m, *grad_leaves(m, T0, q0))
    gerr = {x: max_rel(a, b) for x, a, b in zip("Tq", gs, g1)}
    check(all(bool(torch.isfinite(a).all()) for a in gs) and
          max(gerr.values()) < GRAD_TOL,
          f"{label}: sharded gradient vs unsharded {gerr} >= {GRAD_TOL}")
    loads = step.eval_stats["actual_evals"]
    res = {"shards": SHARDS, "span": step.span,
            "loads_max_over_min": float(loads.max() / loads.min()),
            "launches": launches, "launches_grad": launches_grad,
            "kmax_max_abs": kmax_err, "launch_vs_plain": fwd,
            "backward_vs_plain": bwd, "vs_unsharded": vs,
            "grad_vs_unsharded": gerr,
            "forward_ms": cuda_ms(lambda: m.forward(T0, q0)),
            "shard_ms": [cuda_ms(lambda s=s: step.local(s, T0, q0))
                         for s in range(SHARDS)]}
    if profile:
        trace = Path(profile)

        def whole():
            return step.assemble([step.local(s, T0, q0)
                                  for s in range(SHARDS)])
        res["profile"] = {
            name: profile_step(fn, cuda_ms(fn), str(trace.with_name(
                f"{trace.stem}_{name}{trace.suffix}")), f"{label} {name}")
            for name, fn in (("shard", lambda: step.local(0, T0, q0)),
                             ("sharded", whole))}
    res["graph"] = graph_phase(
        m, [(T0, q0), (T0 + 50.0, q0), (T0 - 50.0, q0)], f"{label} graph",
        fwd=step, eager=lambda T, q: step.assemble(
            [step.local(s, T, q) for s in range(SHARDS)]))
    return res


def shard_phase_text(r: dict, card: str) -> str:
    return (f"{r['shards']} shards of {r['span']} bins, load max/min "
            f"{r['loads_max_over_min']:.4f}; vs unsharded max_rel "
            f"{r['vs_unsharded']:.3e} (bound {BANDED_VS_UNBANDED_TOL}), "
            f"gradient {r['grad_vs_unsharded']} (bound {GRAD_TOL}); a "
            f"shard's step {statistics.median(r['shard_ms']):.3f} ms "
            f"(median of {r['shard_ms']}), the unsharded forward "
            f"{r['forward_ms']:.3f} ms ({card}); launches {r['launches']}, "
            f"gradient {r['launches_grad']}; against plain: " + json.dumps(
                {"layer_kmax_max_abs": r["kmax_max_abs"],
                 **r["launch_vs_plain"], **r["backward_vs_plain"]})) + (
                "" if "profile" not in r else "; profile: " + json.dumps(
                    {k: {x: v[x] for x in ("device_ms", "busy", "kernels")}
                     for k, v in r["profile"].items()})) + (
                "; the compiled step (make_sharded_forward) " +
                graph_text(r["graph"], card))


def sharded_collective(m: TransitModel, T0, q0) -> dict:
    """make_sharded_forward over a world-size-1 NCCL group on the card:
    the compiled collective step (the rank's local replayed from CUDA
    graphs, forward and backward; the all-gather of the parts and the
    all-reduce of the inputs' gradient eager around the replay) bit for
    bit against the eager local assembly, forward and gradient; both
    timed, forward and gradient step.  Multi-card scaling is not measured
    here (one card)."""
    check(dist.is_nccl_available(), "torch.distributed has no NCCL backend")
    store = Path(tempfile.mkdtemp(dir=ROOT / "build"))
    dist.init_process_group("nccl", init_method=f"file://{store / 'nccl'}",
                            world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=MH_TIMEOUT))
    try:
        step = make_sharded_forward(m, group=dist.group.WORLD)
        check(step.nshard == 1 and isinstance(step, GraphedShardedStep),
              f"collective step: {type(step).__name__} of {step.nshard} "
              "shards")

        def local(T, q):
            return step.assemble([step.local(0, T, q)])
        t0 = time.perf_counter()
        with torch.no_grad():
            a = step(T0, q0)
        torch.cuda.synchronize()
        capture_s = time.perf_counter() - t0
        with torch.no_grad():
            b = local(T0, q0)
        check(torch.equal(a, b), "collective step differs from the local "
              f"assembly by {max_rel(a, b):.3e}")
        T, q = grad_leaves(m, T0, q0)
        ga = torch.autograd.grad(step(T, q).sum(), (T, q))
        ga = torch.autograd.grad(step(T, q).sum(), (T, q))   # a replay
        gb = torch.autograd.grad(local(T, q).sum(), (T, q))
        check(all(torch.equal(x, y) for x, y in zip(ga, gb)),
              "collective step's gradient differs from the local "
              "assembly's")
        out = {"backend": dist.get_backend(), "capture_s": capture_s,
               "ms": cuda_ms(nograd(lambda: step(T0, q0))),
               "local_ms": cuda_ms(nograd(lambda: local(T0, q0))),
               "grad_ms": cuda_ms(lambda: torch.autograd.grad(
                   step(T, q).sum(), (T, q))),
               "local_grad_ms": cuda_ms(lambda: torch.autograd.grad(
                   local(T, q).sum(), (T, q)))}
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    return out


def eager_band(run):
    """A copy of the band runner ``run`` (MultihostForward) whose band
    step and band kmax run eagerly (ShardedStep, ``_band_kmax``), to hold
    the compiled ones against."""
    e = copy.copy(run)
    e._step = ShardedStep(run.model, external_kmax=run.exact_ethresh)
    e._kmax_fn = run._band_kmax
    return e


def multihost_worker(rank: int, store: str, io: str):
    """One process of multihost_card: joins the gloo group, builds its
    band of the main path (MultihostForward: balanced bounds, band-local
    TLI read, the global kmax through layer_kmax and an all-reduce MAX;
    on the card the band step and the band kmax are CUDA graph replays),
    runs forward and value_and_grad, the same through the eager band
    step (eager_band), times both, and writes its results to
    ``io``.p<rank>.npz.  The launch counts are the first calls', whose
    warm-up calls before each capture launch the kernels."""
    multihost.initialize(f"file://{store}", MH_PROCS, rank,
                         timeout=datetime.timedelta(seconds=MH_TIMEOUT))
    try:
        d = np.load(f"{io}.in.npz")
        T0, q0 = d["T0"], d["q0"]
        t0 = time.perf_counter()
        run = multihost.MultihostForward(hotjupiter_config(), bands=6,
                                         dtype=torch.float32)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        obs = torch.as_tensor(d["obs"], device=run.model.device)

        def loss_fn(band_spec, blk):
            o = obs[blk[0]:blk[1]]
            return torch.sum(((band_spec - o) / o) ** 2)
        reset_counts(ALL_KERNELS)
        t0 = time.perf_counter()
        spec = run.forward(T0, q0)
        loss, (gT, gq) = run.value_and_grad(loss_fn, T0, q0)
        torch.cuda.synchronize()
        capture_s = time.perf_counter() - t0
        launches = read_counts(ALL_KERNELS)
        check(isinstance(run._step, GraphedShardedStep) and
              run._step._graph.entries and run._kmax_fn.entries,
              "multihost: the band step is not graphed")
        spec, (loss, (gT, gq)) = (run.forward(T0, q0),
                                  run.value_and_grad(loss_fn, T0, q0))
        eager = eager_band(run)
        spec_e = eager.forward(T0, q0)
        loss_e, (gT_e, gq_e) = eager.value_and_grad(loss_fn, T0, q0)
        np.savez(f"{io}.p{rank}.npz", spec=spec.cpu().numpy(),
                 loss=loss.cpu().numpy(), gT=gT.cpu().numpy(),
                 gq=gq.cpu().numpy(), spec_e=spec_e.cpu().numpy(),
                 loss_e=loss_e.cpu().numpy(), gT_e=gT_e.cpu().numpy(),
                 gq_e=gq_e.cpu().numpy(), bounds=run.bounds,
                 block=np.asarray(run.block),
                 n_local_lines=run.n_local_lines,
                 device=str(run.model.device),
                 launches=json.dumps(launches), setup_s=setup_s,
                 capture_s=capture_s,
                 forward_ms=cuda_ms(lambda: run.forward(T0, q0)),
                 band_ms=cuda_ms(lambda: run.local_spectrum(T0, q0)),
                 grad_ms=cuda_ms(lambda: run.value_and_grad(loss_fn, T0,
                                                            q0)),
                 eager_forward_ms=cuda_ms(lambda: eager.forward(T0, q0)),
                 eager_band_ms=cuda_ms(lambda: eager.local_spectrum(T0,
                                                                    q0)),
                 eager_grad_ms=cuda_ms(lambda: eager.value_and_grad(
                     loss_fn, T0, q0)))
    finally:
        dist.destroy_process_group()


def multihost_card(m: TransitModel, T0, q0) -> dict:
    """MH_PROCS processes (torch.multiprocessing.spawn) on the one card
    with a gloo group, each a band of the main path
    (multihost_worker): the gathered spectrum, the same on every process,
    against the single-process main path ``m`` (BANDED_VS_UNBANDED_TOL);
    value_and_grad of chi^2 against an observation (JAX's multi-process
    test's, 0.5 max(F) (1 + 0.1 sin), with a 1-sigma error of the
    observation itself: JAX's sum of squares overflows the float32
    gradient in q of CO2, in one process as in two), its loss to
    BANDED_VS_UNBANDED_TOL and gradient to GRAD_TOL against the single
    process's; each process launched layer_kmax and the line-tile
    kernels; the compiled band step (CUDA graphs) against the eager one
    in each process (the spectrum bit for bit, the loss and gradient
    within GRAPH_TOL of the max), both timed.  The kernels were built
    before the spawn."""
    work = Path(tempfile.mkdtemp(dir=ROOT / "build"))
    try:
        ref = m.forward(T0, q0)
        obs = 0.5 * ref.max() * (1.0 + 0.1 * torch.sin(torch.linspace(
            0.0, 6.0, ref.shape[0], device=ref.device)))
        np.savez(work / "io.in.npz", T0=T0, q0=q0, obs=obs.cpu().numpy())
        T, q = grad_leaves(m, T0, q0)
        loss1 = torch.sum(((m.forward(T, q) - obs) / obs) ** 2)
        g1 = torch.autograd.grad(loss1, (T, q))
        t0 = time.perf_counter()
        ctx = mp.spawn(multihost_worker, args=(str(work / "store"),
                                               str(work / "io")),
                       nprocs=MH_PROCS, join=False)
        # A failed worker raises from join; a hung one is killed.
        while not ctx.join(timeout=1.0):
            if time.perf_counter() - t0 > 2 * MH_TIMEOUT:
                for p in ctx.processes:
                    p.kill()
                raise CheckFailed(f"multihost: the processes did not "
                                  f"finish in {2 * MH_TIMEOUT} s")
        secs = time.perf_counter() - t0
        res = [dict(np.load(work / f"io.p{r}.npz"))
               for r in range(MH_PROCS)]
    finally:
        shutil.rmtree(work, ignore_errors=True)
    graph_vs_eager = {}
    for r in res:
        for k in ("spec", "loss", "gT", "gq"):
            check(np.array_equal(r[k], res[0][k]),
                  f"multihost: processes differ in {k}")
            a, b = np.asarray(r[k], np.float64), np.asarray(r[f"{k}_e"],
                                                            np.float64)
            graph_vs_eager[k] = max(graph_vs_eager.get(k, 0.0), float(
                np.abs(a - b).max() / np.abs(b).max()))
        launched = json.loads(str(r["launches"]))
        check(launched["layer_kmax"] > 0 and
              launched["line_tile_extinction"] > 0,
              f"multihost: a process launched {launched}")
    check(graph_vs_eager["spec"] == 0.0 and
          max(graph_vs_eager.values()) <= GRAPH_TOL,
          f"multihost: graphed vs eager band step {graph_vs_eager} (the "
          f"spectrum bit for bit, the rest <= {GRAPH_TOL} asked)")
    spec = torch.as_tensor(res[0]["spec"], device=ref.device)
    vs = float(((spec - ref).abs() / ref.abs()).max())
    check(spec.shape == ref.shape and vs <= BANDED_VS_UNBANDED_TOL,
          f"multihost: gathered spectrum vs single process {vs:.3e}")
    loss_err = abs(float(res[0]["loss"]) / float(loss1.detach()) - 1.0)
    gerr = {x: max_rel(torch.as_tensor(res[0][k], device=ref.device), b)
            for x, k, b in zip("Tq", ("gT", "gq"), g1)}
    check(loss_err <= BANDED_VS_UNBANDED_TOL and
          max(gerr.values()) < GRAD_TOL,
          f"multihost: loss {loss_err:.3e}, gradient {gerr} vs single "
          f"process")
    return {"processes": MH_PROCS, "seconds": secs,
            "bounds": res[0]["bounds"].tolist(),
            "lines": [int(r["n_local_lines"]) for r in res],
            "devices": [str(r["device"]) for r in res],
            "launches": [json.loads(str(r["launches"])) for r in res],
            "vs_single": vs, "loss_vs_single": loss_err,
            "grad_vs_single": gerr, "graph_vs_eager": graph_vs_eager,
            **{k: [float(r[k]) for r in res] for k in (
                "setup_s", "capture_s", "forward_ms", "band_ms", "grad_ms",
                "eager_forward_ms", "eager_band_ms", "eager_grad_ms")}}


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
    so, log = _build.build(verbose=True)
    _build.load_library()
    ptxas = ptxas_summary(log)
    phase("build", t0, f"({so.relative_to(ROOT)}); backward kernels' "
          f"ptxas: {json.dumps(ptxas)}")

    # 3. Kernels against their plain versions at the fixture and
    #    hot-Jupiter shapes, float32.
    t0 = time.perf_counter()
    fix = TransitModel(fixture_config(), mode="fast",
                       dtype=torch.float32, device=dev)
    kmax_vs_plain(fix, "fixture")
    err_fix = kernel_vs_plain(fix, "fixture")
    phase("kernel_vs_plain_fixture", t0,
          f"max_rel {err_fix['max_rel']:.3e} (nl, ntiles, lmax, tw) "
          f"{err_fix['shape']}")
    t0 = time.perf_counter()
    hj = TransitModel(hotjupiter_config(), mode="fast",
                      dtype=torch.float32, device=dev)
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
          f"the fixture and on {hj.atm.nlayers} hot-Jupiter layers x "
          f"{nlines} lines at the profiles {list(kmax_profiles(hj))} "
          f"(max_abs {kmax_err!r})")
    t0 = time.perf_counter()
    err_hj = kernel_vs_plain(hj, "hotjupiter")
    phase("kernel_vs_plain_hotjupiter", t0,
          f"max_rel {err_hj['max_rel']:.3e} max_abs {err_hj['max_abs']:.3e}")

    # 4. Path 1, the unbanded plan: three retrieval requests.
    t0 = time.perf_counter()
    T0 = np.asarray(hj.atm.temp, dtype=np.float64)
    q0 = np.asarray(hj.atm.q, dtype=np.float64)
    requests = [(T0, q0), (T0 + 50.0, q0), (T0 - 50.0, q0)]
    kernels = (line_tile_extinction, layer_kmax, shell_tile_extinction)
    specs, launches_unb = run_requests(hj, requests, kernels)
    phase("unbanded_path", t0, f"3 forward requests, kernel launches "
          f"{launches_unb}, per forward {per_forward(launches_unb)}")
    for name in ("line_tile_extinction", "layer_kmax"):
        check(launches_unb[name] >= 3,
              f"unbanded path launched {name} {launches_unb[name]} times")
    t0 = time.perf_counter()
    spec_rel = check_spectra(hj, specs, requests, "unbanded")
    c_med, c_p90 = c_median(hj, specs[0])
    check(c_med < C_MEDIAN_TOL,
          f"median vs reference C {c_med:.3e} >= {C_MEDIAN_TOL}")
    phase("unbanded_path_checks", t0,
          f"vs plain path max_rel {spec_rel:.3e}; vs reference C median "
          f"{c_med:.4e} (p90 {c_p90:.4e})")

    # 5. Times (CUDA events, median of RUNS after a warm-up), and the
    #    line-tile kernel's own work against what the function needs.
    t0 = time.perf_counter()
    args, kw = file_state(hj)
    T = args[0]
    tab = layer_tables(hj.fdev, *args)
    coef0 = tab["coef0"]
    ms_kernel = cuda_ms(lambda: line_tile_extinction(
        hj.fplan, hj.fdev, tab, T, **kw))
    ms_kmax = graph_ms(lambda: layer_kmax(hj.fdev, T, coef0))
    ms_kmax_plain = cuda_ms(lambda: plain_kmax(hj.fdev, T, coef0))
    ms_wrapper = cuda_ms(lambda: kernel_extinction(hj.fplan, hj.fdev, *args,
                                                   **kw))
    ms_plain = cuda_ms(lambda: plain_extinction(hj.fplan, hj.fdev, *args,
                                                **kw))
    ms_forward = cuda_ms(lambda: hj.forward(T0, q0))
    counts = work_counts(hj.fplan, hj.fdev, tab, T, **kw)
    bound_ms, bound_by, _, ops, nbytes_ = bound(hj, tab, counts)
    kb_ms, kb_by, kb_unit, kb_ops, kb_bytes = kmax_bound(hj.fdev,
                                                         hj.atm.nlayers)
    phase("unbanded_times", t0,
          f"kernel {ms_kernel:.3f} ms, with prep {ms_wrapper:.3f} ms, plain "
          f"{ms_plain:.3f} ms, forward {ms_forward:.3f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}: {ops:.4e} ops, {nbytes_} bytes); "
          f"layer_kmax {ms_kmax:.4f} ms, plain {ms_kmax_plain:.4f} ms, "
          f"bound {kb_ms:.4f} ms ({kb_by}, {kb_unit}: {kb_ops:.4e} ops, "
          f"{kb_bytes} bytes)")
    print("work " + json.dumps(counts), flush=True)
    t0 = time.perf_counter()
    design = design_counts(hj, tab, counts)
    phase("design_counts", t0, "line-tile kernel counters (equal to the "
          "host count of its design; pairs equal the function's Voigt "
          "evaluations) " + json.dumps(design))
    points = hj.wns.n * hj.atm.nlayers
    print(f"forward unbanded: {points / (ms_forward * 1e-3):.6e} wavenumber "
          f"points x layers per second ({ms_forward:.3f} ms, {card})",
          flush=True)
    t0 = time.perf_counter()
    graph_u = graph_phase(hj, requests, "unbanded")
    phase("graph_unbanded", t0, graph_text(graph_u, card))

    # 6. Path 2, the main path: bands=6 on the same workload.
    t0 = time.perf_counter()
    hjb = TransitModel(hotjupiter_config(), mode="fast",
                       dtype=torch.float32, device=dev,
                       bands=6)
    torch.cuda.synchronize()
    phase("banded_model_setup", t0, plan_summary(hjb))
    t0 = time.perf_counter()
    kmax_err_b = kmax_vs_plain(hjb, "banded")
    err_b = banded_vs_plain(hjb, "banded")
    phase("banded_kernels_vs_plain", t0, "layer_kmax (floor 0) equals "
          f"plain kmax bitwise (max_abs {kmax_err_b!r}); every launch "
          "against its plain version: " + json.dumps(err_b))
    t0 = time.perf_counter()
    specs_b, launches_b = run_requests(hjb, requests, kernels)
    phase("main_path", t0, f"3 forward requests, kernel launches "
          f"{launches_b}, per forward {per_forward(launches_b)}")
    check_launches(hjb, launches_b, "main path")
    t0 = time.perf_counter()
    spec_rel_b = check_spectra(hjb, specs_b, requests, "banded")
    vs_unb = max(float(((a - b).abs() / b.abs()).max())
                 for a, b in zip(specs_b, specs))
    cb_med, cb_p90 = c_median(hjb, specs_b[0])
    check(cb_med < C_MEDIAN_TOL,
          f"banded median vs reference C {cb_med:.3e} >= {C_MEDIAN_TOL}")
    phase("main_path_checks", t0,
          f"vs plain path max_rel {spec_rel_b:.3e}; vs the unbanded kernel "
          f"path max_rel {vs_unb:.3e} (bound {BANDED_VS_UNBANDED_TOL}); vs "
          f"reference C median {cb_med:.4e} (p90 {cb_p90:.4e})")
    # Checked after the last phase, so that a miss still prints every
    # phase's numbers before the script fails.
    deferred = [] if vs_unb <= BANDED_VS_UNBANDED_TOL else [
        f"banded vs unbanded kernel path {vs_unb:.3e} > "
        f"{BANDED_VS_UNBANDED_TOL}"]
    t0 = time.perf_counter()
    ms_fwd_b = cuda_ms(lambda: hjb.forward(T0, q0))
    times_b = banded_times(hjb)
    phase("main_path_times", t0, f"forward {ms_fwd_b:.3f} ms; " +
          json.dumps(times_b))
    print(f"forward banded: {points / (ms_fwd_b * 1e-3):.6e} wavenumber "
          f"points x layers per second ({ms_fwd_b:.3f} ms, {card})",
          flush=True)
    t0 = time.perf_counter()
    grad_b = grad_phase(hjb, requests, "main path grad")
    phase("main_path_grad", t0, f"3 gradient steps; forward "
          f"{grad_b['forward_ms']:.3f} ms, forward+backward "
          f"{grad_b['forward_backward_ms']:.3f} ms (ratio "
          f"{grad_b['ratio']:.3f}); " + json.dumps(
              {k: v for k, v in grad_b.items() if k not in (
                  "forward_ms", "forward_backward_ms", "ratio")}))
    t0 = time.perf_counter()
    batch = batch_phase(hjb, "main path batch")
    phase("main_path_batch", t0, f"B = {BATCH}: {batch['ms_batch']:.3f} ms "
          f"a batch, {batch['ms_member']:.3f} ms a member; with the "
          f"gradient {batch['ms_batch_grad']:.3f} / "
          f"{batch['ms_member_grad']:.3f} ms; " + json.dumps(batch))
    t0 = time.perf_counter()
    shard_b = sharded_phase(hjb, T0, q0, "sharded main", profile)
    phase("sharded_main", t0, shard_phase_text(shard_b, card))
    t0 = time.perf_counter()
    coll = sharded_collective(hjb, T0, q0)
    phase("sharded_collective", t0, f"world-size-1 {coll['backend']} group:"
          f" the compiled collective step equals the eager local assembly "
          f"bit for bit, forward and gradient; forward {coll['ms']:.3f} ms "
          f"compiled, {coll['local_ms']:.3f} ms eager; gradient step "
          f"{coll['grad_ms']:.3f} ms compiled, {coll['local_grad_ms']:.3f} "
          f"ms eager ({card}); capture {coll['capture_s']:.2f} s; scaling "
          f"over cards is not measured (one card)")
    t0 = time.perf_counter()
    mh = multihost_card(hjb, T0, q0)
    phase("multihost_card", t0, f"{MH_PROCS} processes on one card (gloo):"
          f" bounds {mh['bounds']}, lines per band {mh['lines']}; gathered "
          f"spectrum vs single process max_rel {mh['vs_single']:.3e}, loss "
          f"{mh['loss_vs_single']:.3e}, gradient {mh['grad_vs_single']}; "
          f"spawn to exit {mh['seconds']:.2f} s ({card}); the compiled "
          f"band step vs the eager one {mh['graph_vs_eager']}; " +
          json.dumps({k: mh[k] for k in (
              "devices", "launches", "setup_s", "capture_s", "forward_ms",
              "eager_forward_ms", "band_ms", "eager_band_ms", "grad_ms",
              "eager_grad_ms")}))
    t0 = time.perf_counter()
    graph_b = graph_phase(hjb, requests, "main", profile=profile)
    settings_b = graph_settings(hjb, T0, q0)
    phase("graph_main", t0, graph_text(graph_b, card) + "; make_forward "
          "after set_cloudtop equals the eager forward with the new deck "
          "bit for bit, one made before it the old deck (the deck moved "
          f"the spectrum by max_rel {settings_b['moved_max_rel']:.3e})")
    t0 = time.perf_counter()
    graph_bb = graph_phase(hjb, requests, "main batch", batch=BATCH,
                           profile=profile)
    phase("graph_main_batch", t0, f"B = {BATCH}: " +
          graph_text(graph_bb, card))
    if profile:
        # After the timed phases: a profiler pass slows the host's
        # dispatch for the rest of the process.
        t0 = time.perf_counter()
        profile_forward(hjb, T0, q0, ms_fwd_b, profile, "banded")
        phase("profile", t0)
        t0 = time.perf_counter()
        leaves = grad_leaves(hjb, T0, q0)
        trace = Path(profile)
        profile_step(lambda: grad_step(hjb, *leaves),
                     grad_b["forward_backward_ms"],
                     str(trace.with_name(f"{trace.stem}_grad{trace.suffix}")),
                     "banded grad")
        phase("profile_grad", t0)

    # 7. Path 3: bands=6 at 0.05 cm-1, with decimated far-wing shells.
    t0 = time.perf_counter()
    hjf = TransitModel(hotjupiter_config(0.05), mode="fast",
                       dtype=torch.float32,
                       device=dev, bands=6)
    check((hjf.wns.n, hjf.atm.nlayers) == HJ_FINE_SHAPE,
          f"0.05 cm-1 grid {hjf.wns.n} x {hjf.atm.nlayers}")
    strides = sorted({s for far in hjf.bplan.far_plans if far
                      for *_, s in far})
    check(max(strides) > 1, f"no decimated shell at 0.05 cm-1: {strides}")
    torch.cuda.synchronize()
    phase("fine_model_setup", t0, plan_summary(hjf))
    t0 = time.perf_counter()
    kmax_err_f = kmax_vs_plain(hjf, "fine")
    err_f = banded_vs_plain(hjf, "fine")
    check("shell_tile_extinction" in err_f, "no shell launch compared")
    phase("fine_kernels_vs_plain", t0, "layer_kmax (floor 0) equals plain "
          f"kmax bitwise (max_abs {kmax_err_f!r}); every launch (the "
          "decimated shells' included) against its plain version: " +
          json.dumps(err_f))
    t0 = time.perf_counter()
    T0f = np.asarray(hjf.atm.temp, dtype=np.float64)
    q0f = np.asarray(hjf.atm.q, dtype=np.float64)
    req_f = [(T0f, q0f), (T0f + 50.0, q0f), (T0f - 50.0, q0f)]
    specs_f, launches_f = run_requests(hjf, req_f, kernels)
    phase("fine_path", t0, f"3 forward requests, kernel launches "
          f"{launches_f}, per forward {per_forward(launches_f)}")
    check_launches(hjf, launches_f, "0.05 cm-1 path")
    check(launches_f["shell_tile_extinction"] <= 2 * 3,
          f"0.05 cm-1 path: more than 2 shell launches per forward")
    t0 = time.perf_counter()
    spec_rel_f = check_spectra(hjf, specs_f, req_f, "fine")
    exact = TransitModel(hotjupiter_config(0.05), mode="fast",
                         dtype=torch.float32,
                         device=dev, bands=6, far_decimate=False)
    s_exact = exact.forward(T0f, q0f)
    dec_shift = float(((specs_f[0] - s_exact).abs() / s_exact.abs()).max())
    del exact
    phase("fine_path_checks", t0,
          f"vs plain path max_rel {spec_rel_f:.3e}; far_decimate=False "
          f"differs by max_rel {dec_shift:.3e} (for the record)")
    t0 = time.perf_counter()
    ms_fwd_f = cuda_ms(lambda: hjf.forward(T0f, q0f))
    times_f = banded_times(hjf)
    points_f = hjf.wns.n * hjf.atm.nlayers
    phase("fine_path_times", t0, f"forward {ms_fwd_f:.3f} ms; " +
          json.dumps(times_f))
    print(f"forward 0.05 cm-1: {points_f / (ms_fwd_f * 1e-3):.6e} wavenumber "
          f"points x layers per second ({ms_fwd_f:.3f} ms, {card})",
          flush=True)
    t0 = time.perf_counter()
    grad_f = grad_phase(hjf, req_f, "0.05 cm-1 grad")
    check("shell_tile_backward" in grad_f["launch_vs_plain"],
          "no shell backward launch compared")
    phase("fine_path_grad", t0, f"3 gradient steps; forward "
          f"{grad_f['forward_ms']:.3f} ms, forward+backward "
          f"{grad_f['forward_backward_ms']:.3f} ms (ratio "
          f"{grad_f['ratio']:.3f}); " + json.dumps(
              {k: v for k, v in grad_f.items() if k not in (
                  "forward_ms", "forward_backward_ms", "ratio")}))
    t0 = time.perf_counter()
    shard_f = sharded_phase(hjf, T0f, q0f, "sharded 0.05")
    check("shell_tile_extinction" in shard_f["launch_vs_plain"] and
          "shell_tile_backward" in shard_f["backward_vs_plain"],
          "sharded 0.05: no shell launch compared")
    phase("sharded_fine", t0, shard_phase_text(shard_f, card))
    t0 = time.perf_counter()
    graph_f = graph_phase(hjf, req_f, "0.05", profile=profile)
    phase("graph_fine", t0, graph_text(graph_f, card))
    if profile:
        t0 = time.perf_counter()
        trace = Path(profile)
        profile_forward(hjf, T0f, q0f, ms_fwd_f,
                        str(trace.with_name(f"{trace.stem}_0.05"
                                            f"{trace.suffix}")), "0.05")
        phase("profile_0.05", t0)
        t0 = time.perf_counter()
        leaves = grad_leaves(hjf, T0f, q0f)
        profile_step(lambda: grad_step(hjf, *leaves),
                     grad_f["forward_backward_ms"],
                     str(trace.with_name(f"{trace.stem}_grad_0.05"
                                         f"{trace.suffix}")), "0.05 grad")
        phase("profile_grad_0.05", t0)

    # 8. The transit path: the main path's files and plan in transit
    #    geometry with hydrostatic radii (radii, path weights and the
    #    modulation table rebuilt from T and q at every step).
    t0 = time.perf_counter()
    hjt = TransitModel(transit_config(), mode="fast",
                       dtype=torch.float32, device=dev,
                       bands=6)
    check((hjt.wns.n, hjt.atm.nlayers) == HJ_SHAPE and hjt.hydrostatic,
          f"transit grid {hjt.wns.n} x {hjt.atm.nlayers}")
    torch.cuda.synchronize()
    phase("transit_model_setup", t0, plan_summary(hjt))
    t0 = time.perf_counter()
    specs_t, launches_t = run_requests(hjt, requests, kernels)
    phase("transit_path", t0, f"3 forward requests, kernel launches "
          f"{launches_t}, per forward {per_forward(launches_t)}")
    check_launches(hjt, launches_t, "transit path")
    t0 = time.perf_counter()
    spec_rel_t = check_spectra(hjt, specs_t, requests, "transit")
    m1 = modlevel_m1_vs_plain(hjt, requests)
    radii_err = max(radii_vs_float64(hjt, T, q) for T, q in requests)
    check(radii_err < RADII_TOL, f"transit: float32 radii vs float64 "
          f"{radii_err:.3e} >= {RADII_TOL}")
    phase("transit_path_checks", t0,
          f"vs plain path max_rel {spec_rel_t:.3e}; modlevel -1 vs plain "
          f"max_rel {m1['max_rel']:.3e} ({m1['reached']:.0f} of "
          f"{hjt.wns.n} wavenumbers reach toomuch); hydrostatic radii, "
          f"float32 on the card vs float64 on the CPU, max_rel "
          f"{radii_err:.3e} (bound {RADII_TOL})")
    t0 = time.perf_counter()
    ms_fwd_t = cuda_ms(lambda: hjt.forward(T0, q0))
    times_t, steps_t = transit_times(hjt, T0, q0)
    phase("transit_path_times", t0, f"forward {ms_fwd_t:.3f} ms (the "
          f"eclipse main path's {ms_fwd_b:.3f}); kernel launches per "
          f"forward {per_forward(launches_t)}; " + json.dumps(times_t))
    t0 = time.perf_counter()
    hjt64 = TransitModel(transit_config(), mode="fast",
                         dtype=torch.float64, device=dev,
                         bands=6, use_kernel=False)
    grad_t = grad_phase(hjt, requests, "transit grad", fd_model=hjt64,
                        fd_step=FD_STEP_64)
    del hjt64
    phase("transit_path_grad", t0, f"3 gradient steps; forward "
          f"{grad_t['forward_ms']:.3f} ms, forward+backward "
          f"{grad_t['forward_backward_ms']:.3f} ms (ratio "
          f"{grad_t['ratio']:.3f}); " + json.dumps(
              {k: v for k, v in grad_t.items() if k not in (
                  "forward_ms", "forward_backward_ms", "ratio")}))
    t0 = time.perf_counter()
    batch_t = batch_phase(hjt, "transit batch")
    phase("transit_path_batch", t0, f"B = {BATCH}: {batch_t['ms_batch']:.3f}"
          f" ms a batch, {batch_t['ms_member']:.3f} ms a member; with the "
          f"gradient {batch_t['ms_batch_grad']:.3f} / "
          f"{batch_t['ms_member_grad']:.3f} ms; " + json.dumps(batch_t))

    # 9. HMC over the transit path.
    t0 = time.perf_counter()
    hmc = hmc_phase(hjt)
    phase("hmc", t0, f"{hmc['ms_per_gradient_eval']:.3f} ms per leapfrog "
          f"gradient evaluation ({HMC_CHAINS} chains; through the graphed "
          f"batched step {hmc['ms_per_gradient_eval_graph']:.3f} ms), "
          f"{hmc['ms_per_sample']:.3f} ms per sample, acceptance "
          f"{hmc['acceptance']:.3f}; " + json.dumps(hmc))
    t0 = time.perf_counter()
    graph_t = graph_phase(hjt, requests, "transit", profile=profile)
    phase("graph_transit", t0, graph_text(graph_t, card))
    if profile:
        t0 = time.perf_counter()
        trace = Path(profile)
        prof_t = profile_forward(hjt, T0, q0, ms_fwd_t, str(
            trace.with_name(f"{trace.stem}_transit{trace.suffix}")),
            "transit")
        dev_t = {k: device_ms(f) for k, f in steps_t.items()}
        phase("profile_transit", t0, "device ms and kernels per call: " +
              json.dumps(dev_t) + "; line kernels "
              f"{prof_t['line_tile_kernel'] + prof_t['layer_kmax_kernel']:.4f}"
              f" ms of the forward's {prof_t['device_ms']:.4f}")
        t0 = time.perf_counter()
        leaves = grad_leaves(hjt, T0, q0)
        profile_step(lambda: grad_step(hjt, *leaves),
                     grad_t["forward_backward_ms"],
                     str(trace.with_name(f"{trace.stem}_grad_transit"
                                         f"{trace.suffix}")), "transit grad")
        phase("profile_grad_transit", t0)

    # 10. Exact mode, the JAX package's default and the reference C's
    #     scheme, on hj_ref.cfg as the C binary ran it (194,349 lines on
    #     0.5 cm-1 x 2160, the 60 x 60 profile table): the profile
    #     scatter kernels.
    ex = exact_phases(dev, profile, card)

    # 11. The opacity grid on hj_ref.cfg (bench.py's 25 temperatures):
    #     the exact build through the per-molecule profile_scatter, the
    #     fast build through the banded kernels at unit density, the
    #     grid-interpolation path and the CLI's opacity modes.
    gr = grid_phases(ex.pop("model"), card, profile)

    # 12. Nothing of JAX or of the JAX package was loaded.
    bad = sorted(k for k in sys.modules
                 if k.split(".")[0] in ("jax", "jaxlib", "transit_tpu"))
    check(not bad, f"JAX modules loaded: {bad[:5]}")
    phase("total", t_start)
    check(not deferred, "; ".join(deferred))

    # 13. Result lines, after the card's line.  Launches: the banded
    #    paths' (main path, 0.05 cm-1 and transit), the exact path's for
    #    the profile-scatter kernels; times and bounds per forward of the
    #    main path, the shell kernel's of the 0.05 cm-1 path, the
    #    profile-scatter kernels' of the exact path; the grid builds'
    #    launches and the per-molecule profile_scatter launch's time and
    #    bound beside them.
    def mh_launched(name):
        return sum(r[name] for r in mh["launches"])

    def launched(name):
        return (launches_b[name] + launches_f[name] + launches_t[name] +
                shard_b["launches"][name] + shard_f["launches"][name] +
                mh_launched(name))
    by_path = {k.__name__: {"unbanded": launches_unb[k.__name__],
                            "banded": launches_b[k.__name__],
                            "banded_0.05": launches_f[k.__name__],
                            "transit": launches_t[k.__name__],
                            "sharded_main": shard_b["launches"][k.__name__],
                            "sharded_0.05": shard_f["launches"][k.__name__],
                            "multihost_card": mh_launched(k.__name__)}
               for k in kernels}
    shard_fwd = merge_errors(merge_errors({}, shard_b["launch_vs_plain"]),
                             shard_f["launch_vs_plain"])
    shard_bwd = merge_errors(merge_errors({}, shard_b["backward_vs_plain"]),
                             shard_f["backward_vs_plain"])
    lt, km, sh = (times_b["line_tile_extinction"], times_b["layer_kmax"],
                  times_f["shell_tile_extinction"])
    ltb, shb = (grad_b["times"]["line_tile_backward"],
                grad_f["times"]["shell_tile_backward"])

    def grad_launched(name):
        return (sum(g["launches"][name] for g in (grad_b, grad_f, grad_t)) +
                shard_b["launches_grad"][name] +
                shard_f["launches_grad"][name] + mh_launched(name))

    def bwd_err(name):
        errs = [g["launch_vs_plain"][name] for g in (grad_b, grad_f, grad_t)
                if name in g["launch_vs_plain"]] + [shard_bwd[name]]
        return (max(e["max_abs_temps"] for e in errs),
                {k: max(e["max_rel"][k] for e in errs) for k in GRAD_OUTPUTS})
    print(card, flush=True)
    print(json.dumps({"kernels": [{
        "name": "line_tile_extinction",
        "route": "cuda",
        "source": "transit_tpu_torch/csrc/line_tile.cu",
        "replaces": "transit_tpu/opacities/pallas_lbl.py:38",
        "launches": launched("line_tile_extinction"),
        "launches_by_path": by_path["line_tile_extinction"],
        "max_abs_err": max(err_hj["max_abs"],
                           err_b["line_tile_extinction"]["max_abs"],
                           err_f["line_tile_extinction"]["max_abs"],
                           shard_fwd["line_tile_extinction"]["max_abs"]),
        "max_rel_vs_plain": max(err_hj["max_rel"], err_fix["max_rel"],
                                err_b["line_tile_extinction"]["max_rel"],
                                err_f["line_tile_extinction"]["max_rel"],
                                shard_fwd["line_tile_extinction"]["max_rel"]),
        "ms": lt["ms"],
        "plain_ms": lt["plain_ms"],
        "bound_ms": lt["bound_ms"],
        "bound_by": lt["bound_by"],
        "bound_unit": lt["bound_unit"],
        "library_ms": None,
        "ms_0.05": times_f["line_tile_extinction"]["ms"],
        "bound_ms_0.05": times_f["line_tile_extinction"]["bound_ms"],
        "ms_unbanded": ms_kernel,
        "bound_ms_unbanded": bound_ms,
        "plain_ms_unbanded": ms_plain,
        "launches_grid_build_fast": gr["fast"]["launches"][
            "line_tile_extinction"],
        "max_abs_err_grid_build_fast": gr["fast"]["vs_plain"][
            "line_tile_extinction"]["max_abs"],
        "card": card,
    }, {
        "name": "layer_kmax",
        "route": "cuda",
        "source": "transit_tpu_torch/csrc/line_tile.cu",
        "replaces": "transit_tpu/opacities/pallas_lbl.py:127",
        "launches": launched("layer_kmax"),
        "launches_by_path": by_path["layer_kmax"],
        "max_abs_err": max(kmax_err_b, kmax_err_f, shard_b["kmax_max_abs"],
                           shard_f["kmax_max_abs"]),
        "max_abs_err_unbanded": kmax_err,
        "launches_grid_build_fast": gr["fast"]["launches"]["layer_kmax"],
        "ms": km["ms"],
        "ms_one_launch_events": km["ms_events"],
        "plain_ms": km["plain_ms"],
        "bound_ms": km["bound_ms"],
        "bound_by": km["bound_by"],
        "bound_unit": km["bound_unit"],
        "library_ms": None,
        "card": card,
    }, {
        "name": "shell_tile_extinction",
        "route": "cuda",
        "source": "transit_tpu_torch/csrc/shell_tile.cu",
        "replaces": "transit_tpu/opacities/fast.py:690",
        "launches": launched("shell_tile_extinction"),
        "launches_by_path": by_path["shell_tile_extinction"],
        "max_abs_err": max(err_f["shell_tile_extinction"]["max_abs"],
                           shard_fwd["shell_tile_extinction"]["max_abs"]),
        "max_rel_vs_plain": max(err_f["shell_tile_extinction"]["max_rel"],
                                shard_fwd["shell_tile_extinction"]["max_rel"]),
        "ms": sh["ms"],
        "plain_ms": sh["plain_ms"],
        "bound_ms": sh["bound_ms"],
        "bound_by": sh["bound_by"],
        "bound_unit": sh["bound_unit"],
        "library_ms": None,
        "card": card,
    }] + [{
        "name": name,
        "route": "cuda",
        "source": src,
        "replaces": "transit_tpu/opacities/fast.py:608",
        "launches": grad_launched(name),
        "launches_per_step": {"banded": grad_b["per_step"][name],
                              "banded_0.05": grad_f["per_step"][name],
                              "transit": grad_t["per_step"][name],
                              "sharded_main": shard_b["launches_grad"][name],
                              "sharded_0.05": shard_f["launches_grad"][name],
                              "multihost_card": mh_launched(name)},
        "max_abs_err": bwd_err(name)[0],
        "max_rel_vs_plain_by_output": bwd_err(name)[1],
        "ms": t["ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "bound_unit": t["bound_unit"],
        "bound_terms_ms": t["terms_ms"],
        "library_ms": None,
        "card": card,
    } for name, src, t in (
        ("line_tile_backward", "transit_tpu_torch/csrc/line_tile.cu", ltb),
        ("shell_tile_backward", "transit_tpu_torch/csrc/shell_tile.cu",
         shb))] + [{
        "name": name,
        "route": "cuda",
        "source": "transit_tpu_torch/csrc/profile_scatter.cu",
        "replaces": "transit_tpu/opacities/lbl.py:245",
        "launches": n,
        "max_abs_err": ex["err"][f"{kind}_max_abs"],
        "max_rel_vs_plain": ex["err"][f"{kind}_max_rel"],
        "ms": ex["times"][name]["ms"],
        "plain_ms": ex["times"][name]["plain_ms"],
        "bound_ms": ex["times"][name]["bound_ms"],
        "bound_by": ex["times"][name]["bound_by"],
        "pairs": ex["times"][name]["pairs"],
        "table_elements": ex["times"][name]["table_elements"],
        **(grid_keys(gr) if name == "profile_scatter" else {}),
        # No one PyTorch call computes this ragged gather and scatter-add
        # from these inputs: index_add_ needs the (pair) index and value
        # tensors, which are the plain version's work.
        "library_ms": None,
        "card": card,
    } for name, kind, n in (
        ("profile_scatter", "fwd", ex["launches"]["profile_scatter"]),
        ("profile_scatter_backward", "bwd",
         ex["grad"]["launches"]["profile_scatter_backward"]))],
        "forward_ms": {"unbanded": ms_forward, "banded": ms_fwd_b,
                       "banded_0.05": ms_fwd_f, "transit": ms_fwd_t,
                       "exact": ex["forward_ms"]},
        "gradient_ms": {"banded": grad_b["forward_backward_ms"],
                        "banded_0.05": grad_f["forward_backward_ms"],
                        "transit": grad_t["forward_backward_ms"],
                        "exact": ex["grad"]["forward_backward_ms"]},
        "batch_ms": {"B": BATCH, "batch": batch["ms_batch"],
                     "member": batch["ms_member"],
                     "transit_batch": batch_t["ms_batch"],
                     "transit_member": batch_t["ms_member"]},
        "hmc": {k: hmc[k] for k in ("acceptance", "ms_per_gradient_eval",
                                    "ms_per_gradient_eval_graph",
                                    "ms_per_sample")},
        "graph": {path: {k: g[k] for k in (
            "forward_ms", "eager_forward_ms", "gradient_ms",
            "eager_gradient_ms", "bitwise", "max_rel", "grad_bitwise",
            "grad_max_rel", "replay_device_ms", "replay_kernels",
            "eager_device_ms", "eager_kernels")}
            for path, g in (("unbanded", graph_u), ("main", graph_b),
                            ("main_batch", graph_bb),
                            ("sharded_main", shard_b["graph"]),
                            ("sharded_0.05", shard_f["graph"]),
                            ("0.05", graph_f), ("transit", graph_t),
                            ("exact", ex["graph"]), ("grid", gr["graph"]))},
        "sharded": {path: {k: r[k] for k in (
            "shards", "loads_max_over_min", "vs_unsharded",
            "grad_vs_unsharded", "forward_ms", "shard_ms")}
            for path, r in (("main", shard_b), ("0.05", shard_f))},
        "sharded_collective_ms": {k: coll[k] for k in (
            "ms", "local_ms", "grad_ms", "local_grad_ms")},
        "multihost_card": {k: mh[k] for k in (
            "bounds", "lines", "vs_single", "loss_vs_single",
            "grad_vs_single", "graph_vs_eager", "forward_ms",
            "eager_forward_ms", "band_ms", "eager_band_ms", "grad_ms",
            "eager_grad_ms")},
        "grid": {"shape": GRID_SHAPE,
                 "exact_build_s": gr["exact"]["seconds"],
                 "exact_cells_per_s": gr["exact"]["cells_per_s"],
                 "fast_plan_s": gr["fast"]["plan_seconds"],
                 "fast_build_s": gr["fast"]["seconds"],
                 "fast_cells_per_s": gr["fast"]["cells_per_s"],
                 "consistency_max_rel": gr["consistency"],
                 "l1_fast_vs_exact": gr["l1_fast_vs_exact"],
                 **{k: v for k, v in gr["path"].items()
                    if not k.startswith("profile")},
                 "multihost_grid_vs_full": gr["multihost"]["vs_full"],
                 "cli_grid_bytes_equal": gr["cli"]["grid_bytes_equal"],
                 "cli_grid_max_rel": gr["cli"]["grid_max_rel"]}}),
        flush=True)
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
