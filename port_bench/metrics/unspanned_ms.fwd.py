"""Device ms a step of the forward graph's replay that no span of the
program below ``step`` covers (the spans' coverage of the graph), by the
program's layer map (harness/layers.py), in cells whose step is a
forward."""

from port_bench.harness import layers


def read(ctx):
    t = layers.table(ctx)
    if t is None or ctx.cell.kind != "fwd":
        return None
    return t["unspanned_ms"]["fwd"]
