"""Share of the traced slice, %, in which no device operation ran (the
union of the device intervals), in cells whose step is a gradient step."""

from port_bench.harness import tracing


def read(ctx):
    if ctx.cell.kind != "grad":
        return None
    return 100.0 * (1.0 - tracing.busy_seconds(ctx.slice) /
                    ctx.slice.seconds)
