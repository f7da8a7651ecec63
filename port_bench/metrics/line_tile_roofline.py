"""Fast mode's forward line kernels' share, %, of their roofline bound:
the least time of the work the step's inputs need (each kept line's
strength and width chain, and the w4 Voigt evaluation of every (line,
wavenumber) pair inside its nwidth wing, counted by
reference.fast.pair_regions on the traced slice's profiles) at the
chip's peaks, over the device time a step of line_tile_kernel and
shell_tile_kernel (the kernels that evaluate those sums).

Operations (an add, multiply, compare or max is one; so is a divide or
an exp): per kept (layer, line) entry 27 (strength, the ethresh test,
alphaD, 1/alphaD, y, the wing, the run of bins); per pair 7 (distance,
x, the 1/alphaD and strength products, the sum) plus the w4 region's own
rational (II 48, III 82, IV 120).  MUFU: per entry 3 (two exps and
1/alphaD), per pair the region's reciprocals and exp (II 2, III 1, IV
2).  Bytes: each in-range line's four float32 fields read once, each
row's temperature and five (row, isotope) tables, the output written
once."""

from port_bench.harness import peaks, tracing
from port_bench.reference import fast

OPS_ENTRY, MUFU_ENTRY, OPS_PAIR = 27, 3, 7
OPS_REGION = {"II": 48, "III": 82, "IV": 120}
MUFU_REGION = {"II": 2, "III": 1, "IV": 2}
KERNELS = ("line_tile_kernel", "shell_tile_kernel")


def pairs(ref, T, q):
    c = ref.c
    return fast.pair_regions(ref.L, T, ref.densities(T, q),
                             ref.partition(T), ref.grid, c["nwidth"],
                             c["ethreshold"])


def work_bound(ctx, w, ops_entry, ops_pair, mufu_entry, mufu_region,
               out_rows_bytes):
    """(seconds, term) of the step's work ``w`` (pair_regions' counts per
    step)."""
    ops = ops_entry * w["entries"] + sum(
        (ops_pair + OPS_REGION[r]) * w[r] for r in OPS_REGION)
    mufu = mufu_entry * w["entries"] + sum(mufu_region[r] * w[r]
                                           for r in mufu_region)
    rows = ctx.loop.B * ctx.ref.atm.temp.shape[0]
    niso = ctx.ref.L["iso_mass"].shape[0]
    nbytes = (16 * ctx.ref.L["wavn"].shape[0] + 4 * rows * (1 + 5 * niso) +
              out_rows_bytes * rows)
    return peaks.bound(ops, mufu, nbytes)


def read(ctx):
    t = tracing.device_seconds(
        ctx.slice, lambda n: any(k in n for k in KERNELS)) / ctx.slice.steps
    if t == 0 or ctx.cell.kind != "fwd":
        return None
    w = ctx.per_step("fast_pairs", pairs)
    s, _ = work_bound(ctx, w, OPS_ENTRY, OPS_PAIR, MUFU_ENTRY, MUFU_REGION,
                      4 * ctx.ref.grid[2])
    return 100.0 * s / t
