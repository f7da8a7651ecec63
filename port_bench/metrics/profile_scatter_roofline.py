"""Exact mode's forward scatter kernel's share, %, of its roofline
bound: the least time of what the step's inputs need at the chip's
peaks, over the device time a step of profile_scatter_kernel.

Counted by reference.exact.scatter_work on the traced slice's profiles:
per kept (layer, group) its strength and Doppler index (4 bytes each),
per group with a kept layer its fine bin, coarse bin and isotope (12
bytes), each distinct profile-table element the pairs read (4 bytes),
the (layer, wavenumber) output written once (4 bytes); operations, a
multiply and an add a (layer, group, bin) pair.  The bound is the larger
of bytes / HBM bandwidth and operations / FP32 peak."""

import torch

from port_bench.harness import peaks, tracing
from port_bench.reference import exact


def work(ref, T, q):
    """The counts of one profile, a block of layers at a time."""
    P = ref.plan
    seen = torch.zeros(P.flat.shape[0], dtype=torch.bool, device=T.device)
    used = torch.zeros(P.ng, dtype=torch.bool, device=T.device)
    dens = ref.densities(T, q)
    out = {"kept": 0, "pairs": 0}
    for s in ref.blocks(T.shape[0]):
        w = exact.scatter_work(ref.L, P, T[s], dens[:, s],
                               ref.partition(T[s]), ref.c["ethreshold"],
                               seen, used)
        out = {k: out[k] + w[k] for k in out}
    return {**out, "table": int(seen.sum()), "groups": int(used.sum())}


def read(ctx):
    t = tracing.device_seconds(
        ctx.slice, lambda n: "profile_scatter_kernel" in n) / ctx.slice.steps
    if t == 0 or ctx.cell.kind != "fwd":
        return None
    w = ctx.per_step("scatter", work)
    rows = ctx.loop.B * ctx.ref.atm.temp.shape[0]
    nbytes = (8 * w["kept"] + 12 * w["groups"] + 4 * w["table"] +
              4 * rows * ctx.ref.grid[2])
    s, _ = peaks.bound(2 * w["pairs"], 0, nbytes)
    return 100.0 * s / t
