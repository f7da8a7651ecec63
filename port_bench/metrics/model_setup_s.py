"""Seconds of the program's model constructor (TransitModel.__init__:
files, line plans or groups, profile table, device arrays), by the host
clock around it."""


def read(ctx):
    return ctx.host["model_setup_s"]
