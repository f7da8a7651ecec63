"""Seconds of the first call of the cell's step, which warms and
captures its CUDA graph (step_graph.GraphedStep), by the host clock
around it and a synchronize."""


def read(ctx):
    return ctx.host["capture_s"]
