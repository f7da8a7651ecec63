"""Device ms a step of exact mode's group tables in a gradient step: the
outermost ``groups.*`` spans of the forward graph and of the backward
graph (each chunk's ``groups.recompute`` under torch.func.vjp and its
``groups.vjp``, and autograd's ``groups.*.bwd``), by the program's
layer maps (harness/layers.py), in cells whose step is a gradient
step."""

from port_bench.harness import layers


def read(ctx):
    t = layers.table(ctx)
    if t is None or ctx.cell.kind != "grad":
        return None
    return layers.ms_under(t, ("fwd", "bwd"),
                           lambda n: n.startswith("groups."))
