"""The port's exact mode (TransitModel's default, float64 on the CPU)
against the reference C goldens of tests/test_conformance.py, at its
tolerances: ref_eclipse.npz (CIA, extinction, tau, intensity, flux),
ref_transit.npz (tau, modulation), the toomuch goldens, the
multi-database goldens, the scattering and cloud goldens
(test_conformance.py:147-182), and wnosamp 2160 (:222-238: profiles
of over VOIGT_MAXELEMENTS samples take the VOIGT_QUICK path).  The
goldens are read from file; the port's profile table is built once for
the module (every case but the last shares the conformance grid) and
handed to each model."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from tests.test_conformance import FIX, GOLD, make_config
from transit_tpu_torch.config import TransitConfig
from transit_tpu_torch.model import TransitModel

torch.set_num_threads(1)


def multi_config(solution):
    """tests/test_conformance.py TestMultiDatabase.multi_config."""
    return TransitConfig(
        atm=f"{FIX}/multi.atm", linedb=f"{FIX}/multi.tli",
        csfile=f"{FIX}/test_cia.dat", molfile=f"{FIX}/molecules_multi.dat",
        wnlow=2000.0, wnhigh=2100.0, wndelt=1.0, wnosamp=216, wnfct=1.0,
        ndop=15, nlor=15, nwidth=20.0, ethreshold=1e-8, solution=solution,
        toomuch=1e30, raygrid="0 40 80")


def port(cfg):
    return TransitConfig(**dataclasses.asdict(cfg))


def _config(name):
    """Each golden's configuration (test_conformance.py)."""
    if name == "eclipse":
        return port(make_config("eclipse", 1e30))
    if name == "transit":
        return port(make_config("transit", 1e30))
    if name == "eclipse_toomuch":
        return port(make_config("eclipse", 3.0, raygrid="0 40 80"))
    if name == "transit_toomuch":
        return port(make_config("transit", 5.0))
    if name.startswith("multi_"):
        return multi_config(name[len("multi_"):])
    cfg = port(make_config("eclipse" if name == "eclipse_scat" else
                           "transit", 1e30,
                           raygrid="0 40 80" if name == "eclipse_scat"
                           else "0 20 40 60 80"))
    cfg.scattering = {"eclipse_scat": "0.5", "transit_polar": "polar"}.get(
        name)
    if name == "transit_cloud1":
        cfg.cloud = "ext,1e-8,-1.0,1.5"
    return cfg


@pytest.fixture(scope="module")
def runs():
    """name -> the port's exact compute() result, every model sharing one
    profile table."""
    cache = {}

    def run(name):
        if name not in cache:
            m = TransitModel(_config(name), dtype=torch.float64,
                             device="cpu", table=cache.get("table"))
            assert m.mode == "exact"
            cache.setdefault("table", m.table)
            cache[name] = (m, m.compute())
        return cache[name]
    return run


def golden(name):
    return np.load(os.path.join(GOLD, f"ref_{name}.npz"))


def close_ext(got, ref):
    """tau and extinction: rtol 5e-5, atol 1e-10 of the golden's max."""
    np.testing.assert_allclose(got, ref, rtol=5e-5, atol=ref.max() * 1e-10)


CHECKS = {
    "eclipse": ("cia", "extinction", "tau", "intensity", "spectrum"),
    "transit": ("tau", "spectrum"),
    "eclipse_toomuch": ("spectrum",),
    "transit_toomuch": ("spectrum",),
    "multi_eclipse": ("extinction", "spectrum"),
    "multi_transit": ("spectrum",),
    "eclipse_scat": ("spectrum",),
    "transit_polar": ("tau", "spectrum"),
    "transit_cloud1": ("tau", "spectrum"),
}


@pytest.mark.parametrize("name,what", [(n, w) for n, ws in CHECKS.items()
                                       for w in ws])
def test_exact_matches_c_golden(runs, name, what):
    m, res = runs(name)
    g = golden(name)
    if what == "cia":
        np.testing.assert_allclose(res.cia.numpy(), g["cia"], rtol=1e-8,
                                   atol=1e-30)
    elif what == "extinction":
        close_ext(res.extinction.numpy(), g["ext"])
    elif what == "tau":
        close_ext(res.tau.numpy(), g["tau"])
    elif what == "intensity":
        np.testing.assert_allclose(res.intensity.numpy(),
                                   g["intens"][:, 1:].T, rtol=1e-5)
    else:
        np.testing.assert_allclose(res.spectrum.numpy(), g["spec"],
                                   rtol=1e-5)
    if name == "multi_eclipse":
        assert m.iso.mass.shape[0] == 3 and m.iso.nmol_out == 2


def test_eclipse_full_oversampling():
    """wnosamp = 2160 on 2000-2050 cm-1 (ref_eclipse_osamp2160.npz): the
    table's widest profiles take the VOIGT_QUICK path (extinction.c:
    50-51)."""
    from transit_tpu_torch.opacities.voigt import VOIGT_MAXELEMENTS
    g = golden("eclipse_osamp2160")
    cfg = port(make_config("eclipse", 1e30, raygrid="0 40 80"))
    cfg.wnhigh = 2050.0
    cfg.wnosamp = 2160
    m = TransitModel(cfg, dtype=torch.float64, device="cpu")
    assert int(2 * m.table.profsize.max() + 1) > VOIGT_MAXELEMENTS
    res = m.compute()
    close_ext(res.extinction.numpy(), g["ext"])
    np.testing.assert_allclose(res.spectrum.numpy(), g["spec"], rtol=1e-5)
