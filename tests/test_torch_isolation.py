"""The PyTorch port stands alone: it imports no JAX and nothing of
transit_tpu, and its entry points never fall back to the CPU quietly."""

import dataclasses
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


_MODS = [
    "transit_tpu_torch, transit_tpu_torch.model",
    "transit_tpu_torch.opacities.kernel_lbl, transit_tpu_torch.convert, "
    "transit_tpu_torch.opacities._build, "
    "transit_tpu_torch.opacities.banded, "
    "transit_tpu_torch.opacities.kernel_shell",
    "transit_tpu_torch.opacities.lbl, transit_tpu_torch.opacities.voigt, "
    "transit_tpu_torch.opacities.kernel_profile",
    "transit_tpu_torch.rt.geometry, transit_tpu_torch.rt.transmission, "
    "transit_tpu_torch.rt.orbit, transit_tpu_torch.retrieval",
    "transit_tpu_torch.opacities.grid, transit_tpu_torch.utils.savefiles, "
    "transit_tpu_torch.numerics.resample, transit_tpu_torch.cli",
    "chip_smoke",
    "grad_fd_study",
    "line_tile_ablation",
    "exact_profile",
]


@pytest.fixture(scope="module")
def import_checks():
    """One fresh interpreter per entry of _MODS running _CHECK, all
    started together (each imports torch, ~4 s), by entry."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = {mods: subprocess.Popen(
        [sys.executable, "-c", _CHECK.format(mods=mods)], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for mods in _MODS}
    yield procs
    for p in procs.values():
        if p.poll() is None:
            p.kill()
        p.communicate()


@pytest.mark.parametrize("mods", _MODS)
def test_import_loads_no_jax(import_checks, mods):
    proc = import_checks[mods]
    out, err = proc.communicate(timeout=120)
    assert proc.returncode == 0, err
    assert out.strip() == "clean"


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
    from transit_tpu_torch.config import TransitConfig
    return TransitConfig(**dataclasses.asdict(make_config("eclipse", 1e30)))


def test_model_without_device_or_card_raises(monkeypatch):
    from transit_tpu_torch.model import TransitModel
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TransitModel(_torch_cfg(), mode="fast")


@pytest.mark.parametrize("change", [dict(wn_window=(0, 50))])
def test_unported_options_raise(change):
    """Options of slices not ported yet raise with the slice's name, in
    either mode (exact mode is ported: tests/test_torch_exact_*.py; the
    opacity grid and the savefile: tests/test_torch_grid_*.py)."""
    from transit_tpu_torch.model import TransitModel
    for mode in ("exact", "fast"):
        with pytest.raises(NotImplementedError, match="slice"):
            TransitModel(_torch_cfg(), mode=mode, device="cpu", **change)


@pytest.mark.parametrize("option", ["opacityfile", "saveext"])
def test_grid_options_run(tmp_path, option):
    """cfg.opacityfile and cfg.saveext, which raised until the
    opacity-grid slice, now run: an opacityfile that does not exist
    leaves the model on its line list (the CLI builds the grid first,
    mode b), one that exists is read (grid mode); a saveext is written
    by compute and then read back."""
    from transit_tpu_torch.model import TransitModel
    from tests.test_opacity_grid import grid_config
    from tests.test_conformance import GOLD
    cfg = _torch_cfg()
    path = str(tmp_path / option)
    setattr(cfg, option, path)
    m = TransitModel(cfg, mode="fast", dtype=torch.float64, device="cpu")
    assert m.ogrid is None and m.tli is not None
    spec = m.compute().spectrum
    assert bool(torch.isfinite(spec).all())
    if option == "saveext":
        assert os.path.exists(path)
        again = TransitModel(cfg, mode="fast", dtype=torch.float64,
                             device="cpu").compute().spectrum
        assert torch.allclose(again, spec, rtol=1e-12, atol=0.0)
    else:
        g = dataclasses.asdict(grid_config())
        g["opacityfile"] = os.path.join(GOLD, "ref_opacity_grid.bin")
        from transit_tpu_torch.config import TransitConfig
        mg = TransitModel(TransitConfig(**g), dtype=torch.float64,
                          device="cpu")
        assert mg.ogrid is not None and mg.tli is None
        assert bool(torch.isfinite(mg.compute().spectrum).all())


def test_unported_banded_options_raise():
    """wn_window and kmax_override (the multi-process bands slice) raise
    with their slice's name."""
    from transit_tpu_torch.model import TransitModel
    from transit_tpu_torch.opacities.banded import banded_kernel_extinction
    with pytest.raises(NotImplementedError, match="wn_window.*slice"):
        TransitModel(_torch_cfg(), mode="fast",
                     device="cpu", bands=6, wn_window=(0, 50))
    m = TransitModel(_torch_cfg(), mode="fast",
                     dtype=torch.float64, device="cpu",
                     bands=6)
    t = m._t(m.atm.temp)
    with pytest.raises(NotImplementedError, match="kmax_override.*slice"):
        banded_kernel_extinction(
            m.bplan, m.bdev, t * m.atm.tfct, m._t(m.atm.d), m.partition(t),
            m._molm_t, m._molrad_t, wn_i=m.wns.i, dwn=m.wns.d,
            ethresh=m.cfg.ethreshold, nwidth=m.cfg.nwidth,
            kmax_override=torch.ones_like(t))


@pytest.mark.parametrize("bands", [0, 6])
def test_unported_step_options_raise(bands):
    """No step option raises NotImplementedError any more: hydrostatic
    radii run in forward and forward_batch, on the unbanded and on the
    banded model (tests/test_torch_transit_hydro*.py hold them to JAX);
    forward_batch refuses only the raddelt resampling, with a ValueError
    (tests/test_torch_raddelt.py)."""
    from transit_tpu_torch.model import TransitModel
    cfg = _torch_cfg()
    m = TransitModel(cfg, mode="fast",
                     dtype=torch.float64, device="cpu", bands=bands)
    assert (m.bplan is not None) == (bands > 0)
    T = torch.as_tensor(m.atm.temp)
    q = torch.as_tensor(m.atm.q)
    static = m.forward_batch(T[None], q[None])
    assert static.shape == (1, m.wns.n)
    cfg.gsurf, cfg.refpress, cfg.refradius = 2000.0, 0.1, 7e9
    hydro = m.forward_batch(T[None], q[None])
    assert hydro.shape == (1, m.wns.n) and bool(torch.isfinite(hydro).all())
    assert torch.equal(hydro[0], m.forward(T, q))
    assert not torch.equal(hydro, static)
