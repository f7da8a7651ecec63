"""A cell of BENCHMARK.json and the files it is made of, found by name:
``port_bench/configs/<config>.json``, ``port_bench/traffic/<traffic>.json``,
``port_bench/limits/<cell>.json`` and, for each per-layer metric the cell
reports, ``port_bench/metrics/<metric>.py``."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "port_bench"


@dataclasses.dataclass
class Cell:
    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list       # the BENCHMARK.json entries the cell reports
    per_layer: list

    @property
    def kind(self) -> str:
        """"fwd" or "grad": the step the traffic drives."""
        return "grad" if self.traffic["step"] == "gradient" else "fwd"


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = _json(root / "BENCHMARK.json")
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    w = found[0]
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    per = [m for m in bench["per_layer"]
           if (name in m["workloads"] if "workloads" in m
               else m["moves"] in reported)]
    b = root / "port_bench"
    return Cell(name=name, config_name=w["config"],
                traffic_name=w["traffic"], chips=w["chips"],
                config=_json(b / "configs" / f"{w['config']}.json"),
                traffic=_json(b / "traffic" / f"{w['traffic']}.json"),
                limits=_json(b / "limits" / f"{name}.json"),
                end_to_end=e2e, per_layer=per)


def metric_module(name: str, root: Path = ROOT):
    """The module ``port_bench/metrics/<name>.py`` (a metric's name may
    hold dots, so it is loaded from its path)."""
    path = root / "port_bench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "port_bench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, root: Path = ROOT):
    """The ``read(ctx)`` function of ``port_bench/metrics/<name>.py``."""
    return metric_module(name, root).read
