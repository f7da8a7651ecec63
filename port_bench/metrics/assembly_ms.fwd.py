"""Device ms a step under the program's ``assembly`` span in the forward
graph (model._assemble: scattering and clouds, CIA, the optical depth,
the emission), by the program's layer map (harness/layers.py), in cells
whose step is a forward."""

from port_bench.harness import layers


def read(ctx):
    t = layers.table(ctx)
    if t is None or ctx.cell.kind != "fwd":
        return None
    return layers.ms_under(t, ("fwd",), lambda n: n == "assembly")
