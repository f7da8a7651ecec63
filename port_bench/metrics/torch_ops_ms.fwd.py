"""Device ms a step of every device operation that is not one of the
port's own kernels (tracing.PORT_KERNELS): the PyTorch-op layers (exact
mode's group tables, CIA, the optical depth, the emission, autograd's
backward of them, the harness's chi-square), in cells whose step is a
forward."""

from port_bench.harness import tracing


def read(ctx):
    if ctx.cell.kind != "fwd":
        return None
    s = tracing.device_seconds(ctx.slice, lambda n: not tracing.is_port(n))
    return 1e3 * s / ctx.slice.steps
