"""Small cells for the CPU tests: the hot-Jupiter files on a 40 cm-1
slice (2000-2040 cm-1, 81 wavenumbers), exact mode with a 15 x 15
profile table and 54 fine bins a wavenumber."""

from __future__ import annotations

import copy
import json

from port_bench.harness.spec import BENCH, Cell

SLICE = {"wnlow": 2000.0, "wnhigh": 2040.0, "wnosamp": 54, "ndop": 15,
         "nlor": 15}


def config(name: str, copies: int = 0) -> dict:
    with open(BENCH / "configs" / f"{name}.json") as f:
        c = json.load(f)
    c["transit"].update(SLICE)
    if c.get("lines"):
        c["lines"]["copies"] = copies or 2
    return c


def cell(config_name: str, traffic_name: str, **traffic) -> Cell:
    with open(BENCH / "traffic" / f"{traffic_name}.json") as f:
        tr = json.load(f)
    tr.update(check_span=4, check_steps=1, trace_start=1, trace_steps=2,
              check_members=tr["batch"],
              pool=8 if tr["batch"] > 1 else 4)
    tr.update(traffic)
    grad = tr["step"] == "gradient"
    limits = {"spectrum": 1e-4, "control": "tf32"}
    if grad:
        limits.update(grad_T=1e-3, grad_q=1e-3)
    return Cell(name=f"{config_name}.{traffic_name}", config_name=config_name,
                traffic_name=traffic_name, chips=1,
                config=config(config_name), traffic=tr, limits=limits,
                end_to_end=[], per_layer=[])


def with_limits(c: Cell, **limits) -> Cell:
    c = copy.deepcopy(c)
    c.limits.update(limits)
    return c
