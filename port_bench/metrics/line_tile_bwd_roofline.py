"""Fast mode's backward line kernels' share, %, of their roofline bound:
the least time of the VJP work the step's inputs need at the chip's
peaks, over the device time a step of line_tile_bwd_kernel and
shell_tile_bwd_kernel.

The pairs are those of line_tile_roofline (reference.fast.pair_regions
on the traced slice's profiles).  Operations: per kept (layer, line)
entry the forward chain (27) and its chain to the cotangents of T and
the four tables (26); per pair the distance and x (4), the w4 pair
(Re, Im: the region's count and 6 more), the two Faddeeva partials (9)
and the three bin sums (11).  MUFU: per entry 3, per pair the region's
reciprocals (II 2, III 1, IV 1).  Bytes: the lines and tables read
once, the (row, wavenumber) cotangent read once, the (row, isotope)
gradients written once."""

from port_bench.harness import tracing
from port_bench.harness.spec import metric_module

fwd = metric_module("line_tile_roofline")

OPS_ENTRY, MUFU_ENTRY, OPS_PAIR = 27 + 26, 3, 4 + 6 + 9 + 11
MUFU_REGION = {"II": 2, "III": 1, "IV": 1}
KERNELS = ("line_tile_bwd_kernel", "shell_tile_bwd_kernel")


def read(ctx):
    t = tracing.device_seconds(
        ctx.slice, lambda n: any(k in n for k in KERNELS)) / ctx.slice.steps
    if t == 0 or ctx.cell.kind != "grad":
        return None
    w = ctx.per_step("fast_pairs", fwd.pairs)
    niso = ctx.ref.L["iso_mass"].shape[0]
    s, _ = fwd.work_bound(ctx, w, OPS_ENTRY, OPS_PAIR, MUFU_ENTRY,
                          MUFU_REGION, 4 * ctx.ref.grid[2] + 4 * 5 * niso)
    return 100.0 * s / t
