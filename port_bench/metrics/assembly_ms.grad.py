"""Device ms a step under the program's ``assembly`` span in the forward
graph and ``assembly.bwd`` (autograd's backward of it) in the backward
graph, by the program's layer maps (harness/layers.py), in cells whose
step is a gradient step."""

from port_bench.harness import layers


def read(ctx):
    t = layers.table(ctx)
    if t is None or ctx.cell.kind != "grad":
        return None
    return layers.ms_under(t, ("fwd", "bwd"),
                           lambda n: n in ("assembly", "assembly.bwd"))
