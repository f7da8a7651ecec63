"""Device ms a step of exact mode's group tables in the forward graph:
the program's outermost ``groups.*`` spans (lbl.layer_groups: the
strengths and ethresh pass, the co-add pass, the Doppler fill), by the
layer map the program recorded when it captured the step
(harness/layers.py), in cells whose step is a forward."""

from port_bench.harness import layers


def read(ctx):
    t = layers.table(ctx)
    if t is None or ctx.cell.kind != "fwd":
        return None
    return layers.ms_under(t, ("fwd",), lambda n: n.startswith("groups."))
