"""Device ms a step of the forward and backward graphs' replays that no
span of the program below ``step`` (``step.bwd``) covers, by the
program's layer maps (harness/layers.py), in cells whose step is a
gradient step."""

from port_bench.harness import layers


def read(ctx):
    t = layers.table(ctx)
    if t is None or ctx.cell.kind != "grad":
        return None
    return t["unspanned_ms"]["fwd"] + t["unspanned_ms"]["bwd"]
