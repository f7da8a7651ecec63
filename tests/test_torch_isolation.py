"""The PyTorch port stands alone: it imports no JAX and nothing of
transit_tpu, and its entry points never fall back to the CPU quietly."""

import os
import re
import subprocess
import sys

import pytest
import torch

from tests.test_conformance import make_config

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "transit_tpu_torch")

_CHECK = (
    "import sys\n"
    "import {mods}\n"
    "bad = sorted(m for m in sys.modules if m == 'jax' or "
    "m.startswith('jax.') or m == 'jaxlib' or m.startswith('jaxlib.') or "
    "m == 'transit_tpu' or m.startswith('transit_tpu.'))\n"
    "assert not bad, bad\n"
    "print('clean')\n")


@pytest.mark.parametrize("mods", [
    "transit_tpu_torch, transit_tpu_torch.model",
    "transit_tpu_torch.opacities.kernel_lbl, transit_tpu_torch.convert, "
    "transit_tpu_torch.opacities._build",
    "chip_smoke",
])
def test_import_loads_no_jax(mods):
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", _CHECK.format(mods=mods)],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "clean"


def _sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(PKG):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


_IMPORT = re.compile(r"^\s*(?:import|from)\s+(jax|jaxlib|transit_tpu)\b",
                     re.M)
_DYNAMIC = re.compile(
    r"(?:import_module|__import__)\(\s*['\"](jax|jaxlib|transit_tpu)\b")


def test_sources_import_no_jax_and_no_transit_tpu():
    srcs = _sources()
    assert len(srcs) > 10
    for path in srcs:
        with open(path) as f:
            text = f.read()
        assert not _IMPORT.findall(text), path
        assert not _DYNAMIC.findall(text), path


def _torch_cfg():
    import dataclasses
    from transit_tpu_torch.config import TransitConfig
    return TransitConfig(**dataclasses.asdict(make_config("eclipse", 1e30)))


def test_model_without_device_or_card_raises(monkeypatch):
    from transit_tpu_torch.model import TransitModel
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TransitModel(_torch_cfg())


@pytest.mark.parametrize("change", [
    dict(mode="exact"), dict(bands=6), dict(solution="transit"),
    dict(raddelt=100.0), dict(opacityfile="grid.bin"),
    dict(saveext="ext.save")])
def test_unported_options_raise(change):
    from transit_tpu_torch.model import TransitModel
    cfg = _torch_cfg()
    kw = {}
    for k, v in change.items():
        if k in ("mode", "bands"):
            kw[k] = v
        else:
            setattr(cfg, k, v)
    with pytest.raises(NotImplementedError, match="slice"):
        TransitModel(cfg, device="cpu", **kw)


def test_unported_step_options_raise():
    from transit_tpu_torch.model import TransitModel
    cfg = _torch_cfg()
    m = TransitModel(cfg, dtype=torch.float64, device="cpu")
    T = torch.as_tensor(m.atm.temp)
    q = torch.as_tensor(m.atm.q)
    with pytest.raises(NotImplementedError, match="slice"):
        m.forward_batch(T[None], q[None])
    cfg.gsurf, cfg.refpress, cfg.refradius = 2000.0, 0.1, 7e9
    with pytest.raises(NotImplementedError, match="slice"):
        m.forward(T, q)
