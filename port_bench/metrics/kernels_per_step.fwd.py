"""Device kernels a step in the traced slice (copies and fills not
counted), in cells whose step is a forward."""

from port_bench.harness import tracing


def read(ctx):
    if ctx.cell.kind != "fwd":
        return None
    n = sum(tracing.is_kernel(name) for name, _, _ in ctx.slice.device)
    return n / ctx.slice.steps
