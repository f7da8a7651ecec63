"""The harness end to end on the CPU at a small size (the hot-Jupiter
slice of tests/cells.py), without its look for a card: one run of a
forward and of a gradient cell, traced; the faults the check must
catch, planted under the timed path; the control; the result line and
the refusals of run.py; and what the benchmark imports."""

from __future__ import annotations

import ast
import json
import shutil
import subprocess
import sys

import pytest
import torch

from port_bench import run
from port_bench.harness import spec
from port_bench.tests.cells import cell, with_limits

torch.set_num_threads(1)
CPU = torch.device("cpu")
SEED = 2 ** 31 + 12345


def _bench_per_layer(c):
    with open(spec.ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    c.per_layer = [m for m in bench["per_layer"]
                   if c.kind in m["name"] or "workloads" not in m]
    return c


# Limits of the small cells: the float32 program against the float64
# reference on this slice reads ~5e-4 (fast spectra), ~7e-3 (fast
# gradients), ~1e-6 (exact).
SMALL = {"hj_fast": dict(spectrum=2e-3, grad_T=2e-2, grad_q=2e-2),
         "hj_exact_4m9": dict(spectrum=1e-5, grad_T=1e-4, grad_q=1e-4)}


def _cell(config_name, traffic_name):
    c = _bench_per_layer(cell(config_name, traffic_name))
    return with_limits(c, **{k: v for k, v in SMALL[config_name].items()
                             if k == "spectrum" or c.kind == "grad"})


@pytest.mark.parametrize("names", [("hj_fast", "fwd_b8"),
                                   ("hj_exact_4m9", "grad")])
def test_rehearsal(names):
    c = _cell(*names)
    res = run.run_cell(c, SEED, 0.5, True, CPU)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 3 * c.traffic["batch"]
    assert set(res["checks"]) == set(run_checks(c))
    m = res["metrics"]
    assert m["model_setup_s"]["value"] > 0 and m["capture_s"]["value"] > 0
    assert m[f"kernels_per_step.{c.kind}"]["value"] == 0   # no card
    assert res["device"]["window_s"] > 0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def run_checks(c):
    return ["spectrum"] + (["grad_T", "grad_q"] if c.kind == "grad" else [])


class _Faulty:
    """The compiled step with a fault planted in what it returns."""

    def __init__(self, fwd, fault):
        self.fwd, self.fault, self.last = fwd, fault, None

    def __call__(self, T, q):
        out = self.fwd(T, q)
        if self.fault == "stale":
            # The previous call's answer returned again (zero gradient).
            prev, self.last = self.last, out.detach()
            if prev is not None:
                out = prev + 0.0 * out
        elif self.fault == "half_batch":
            # The second half of the batch left out: the mean of the
            # first half in its place.
            h = out.shape[0] // 2
            out = torch.cat([out[:h], out[:h].mean(0).expand(
                out.shape[0] - h, -1)])
        elif self.fault == "altered":
            # One profile's answer altered where it is produced.
            out = torch.cat([out[:1] * 1.01, out[1:]])
        return out


@pytest.mark.parametrize("fault", ["stale", "half_batch", "altered"])
def test_faults_are_not_correct(fault, monkeypatch):
    build = run.build_program

    def faulty(*a, **k):
        model, fwd, s = build(*a, **k)
        return model, _Faulty(fwd, fault), s
    monkeypatch.setattr(run, "build_program", faulty)
    c = _cell("hj_fast", "grad_b8" if fault == "stale" else "fwd_b8")
    res = run.run_cell(c, SEED, 0.3, False, CPU)
    assert not res["correct"], res["checks"]


# One twentieth of the rows: a chunk of exact mode's layers (13 of its
# 100 at the timed size) or a band of fast mode's (6 bands of ~17).
CHUNK = slice(13, 26)
BAND = slice(17, 34)
# The kinds of number the timed cells compare, at the small cells' size.
PARTIAL = {"hj_fast": dict(grad_T_median=2e-2, grad_q_median=2e-2,
                           grad_T_p95=2e-2, grad_q_p95=2e-2),
           "hj_exact_4m9": dict(spectrum_median=1e-5, spectrum_p95=1e-5,
                                grad_T_median=1e-4, grad_q_median=1e-4,
                                grad_T_p95=1e-4, grad_q_p95=1e-4)}


class _RowsOff(torch.autograd.Function):
    """The identity, whose backward scales the gradient of some layers:
    a backward that is wrong in one band of layers."""

    @staticmethod
    def forward(x, rows, scale):
        return x.view_as(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.rows, ctx.scale = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        g[..., ctx.rows] *= ctx.scale
        return g, None, None


def _partial_cell(config_name, traffic_name):
    c = cell(config_name, traffic_name)
    c.limits = {k: v for k, v in PARTIAL[config_name].items()
                if k.startswith("spectrum") or c.kind == "grad"}
    c.limits["control"] = "tf32"
    return c


def _partial_failures(res):
    return {k for k, v in res["checks"].items() if v["value"] > v["limit"]}


def _chunks_of_13(monkeypatch):
    """Exact mode in chunks of 13 layers, as at the timed size (the small
    cells' layers fit one chunk)."""
    from transit_tpu_torch.opacities import lbl
    monkeypatch.setattr(lbl, "chunk_rows", lambda *a, **k: CHUNK.start)


def test_partial_numbers_pass_a_sound_run(monkeypatch):
    _chunks_of_13(monkeypatch)
    for names in (("hj_fast", "grad_b8"), ("hj_exact_4m9", "grad")):
        res = run.run_cell(_partial_cell(*names), SEED, 0.3, False, CPU)
        assert res["correct"], (names, res["checks"])


def test_one_band_wrong_is_not_correct(monkeypatch):
    """The fast gradient 5% off in one band of layers: the medians over
    the elements stay within their limits, the 95th percentiles do
    not."""
    build = run.build_program

    def faulty(*a, **k):
        model, fwd, s = build(*a, **k)

        def step(T, q):
            return fwd(_RowsOff.apply(T, BAND, 1.05),
                       _RowsOff.apply(q, BAND, 1.05))
        return model, step, s
    monkeypatch.setattr(run, "build_program", faulty)
    res = run.run_cell(_partial_cell("hj_fast", "grad_b8"), SEED, 0.3,
                       False, CPU)
    assert not res["correct"]
    assert _partial_failures(res) == {"grad_T_p95", "grad_q_p95"}, \
        res["checks"]


@pytest.mark.parametrize("traffic_name", ["fwd", "grad"])
def test_one_chunk_wrong_is_not_correct(traffic_name, monkeypatch):
    """Exact mode's line extinction (forward) or its recompute (gradient)
    1% off in its second chunk of 13 layers, planted in the program's
    chunked extinction: only the 95th percentiles fail."""
    from transit_tpu_torch.opacities import kernel_profile as kp

    _chunks_of_13(monkeypatch)

    if traffic_name == "fwd":
        fwd = kp.ChunkedExtinction.forward

        def off(temps, densities, Z, op):
            out = fwd(temps, densities, Z, op).clone()
            out[CHUNK] *= 1.01
            return out
        monkeypatch.setattr(kp.ChunkedExtinction, "forward",
                            staticmethod(off))
    else:
        vjp = kp.ChunkedExtinctionVjp.forward

        def off(ct, temps, densities, Z, op):
            gT, gD, gZ = vjp(ct, temps, densities, Z, op)
            return gT * _rows(gT, 1.01), gD * _rows(gT, 1.01), \
                gZ * _rows(gT, 1.01)
        monkeypatch.setattr(kp.ChunkedExtinctionVjp, "forward",
                            staticmethod(off))
    res = run.run_cell(_partial_cell("hj_exact_4m9", traffic_name), SEED,
                       0.3, False, CPU)
    assert not res["correct"]
    fails = _partial_failures(res)
    assert fails and all(k.endswith("_p95") for k in fails), res["checks"]


def _rows(like, scale):
    w = torch.ones(like.shape[-1], dtype=like.dtype, device=like.device)
    w[CHUNK] = scale
    return w


def test_control_fails_the_limit():
    """The control (the reference in bfloat16 in the program's place)
    reads above the small fast cell's limit."""
    c = _cell("hj_fast", "fwd_b8")
    c.limits["control"] = "bfloat16"
    res = run.run_cell(c, SEED, 0.3, False, CPU, control=True)
    assert res["readings"]["spectrum"] > 3 * c.limits["spectrum"]


def test_refuses_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    rc = run.main(["--workload", "hj_fast.fwd_b8", "--seed", "1",
                   "--seconds", "1"])
    assert rc != 0 and capsys.readouterr().out == ""


def test_refuses_with_only_the_benchmark(tmp_path):
    """A directory that holds only BENCHMARK.json and the files under
    paths: the run exits non-zero and prints no result."""
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.BENCH, tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "port_bench/run.py", "--workload",
                        "hj_fast.fwd_b8", "--seed", "1", "--seconds", "1"],
                       cwd=tmp_path, capture_output=True, text=True,
                       timeout=120)
    assert p.returncode != 0 and p.stdout == ""


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


def test_imports():
    """No module of port_bench imports jax, jaxlib, flax or transit_tpu
    (top-level names compared whole); the reference imports nothing of
    the program either."""
    banned = {"jax", "jaxlib", "flax", "transit_tpu"}
    for path in spec.BENCH.rglob("*.py"):
        names = set(_imports(path))
        assert not names & banned, (path, names & banned)
        if "reference" in path.parts:
            assert "transit_tpu_torch" not in names, path


def test_run_loads_no_jax():
    """A run's process never loads them: the check run.py makes after
    the window finds nothing after a CPU run."""
    run.run_cell(_cell("hj_exact_4m9", "fwd"), SEED, 0.2, False, CPU)
    assert run.forbidden_modules() == []


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["hj_fast.fwd_b8", "hj_exact_4m9.fwd"])
def test_cell_on_card(card, workload, capsys):
    rc = run.main(["--workload", workload, "--seed", str(SEED),
                   "--seconds", "2"])
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and res["correct"], res


@pytest.mark.cuda
def test_exact_control_on_card(card, capsys):
    """The TF32 control reads above the exact cell's limit."""
    rc = run.main(["--workload", "hj_exact_4m9.fwd", "--seed", str(SEED),
                   "--seconds", "1", "--control", "1"])
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0
    assert any(res["readings"][k] > v for k, v in res["limits"].items())
