"""The plain reference against the port's CPU model in float64, on the
hot-Jupiter files' 2000-2040 cm-1 slice: spectra and the gradients of a
chi-square, in fast mode (bands=6) and exact mode (a 15 x 15 profile
table, 54 fine bins a wavenumber); and the reference's co-add groups
against the port's native partition on the split line list."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from port_bench import run
from port_bench.harness import traffic
from port_bench.harness.spec import ROOT
from port_bench.reference import exact
from port_bench.reference.inputs import load_problem
from port_bench.reference.model import Reference
from port_bench.tests.cells import config

torch.set_num_threads(1)


class _Cell:
    def __init__(self, cfg):
        self.config = cfg


@pytest.fixture(scope="module", params=["hj_fast", "hj_exact_4m9"])
def pair(request, tmp_path_factory):
    """(reference, program model, problem) of one mode on the slice."""
    cfg = config(request.param)
    cfg["model"]["dtype"] = "float64"
    tli = None
    prob = load_problem(cfg, ROOT)
    if cfg.get("lines"):
        tli = tmp_path_factory.mktemp("lines") / "lines.tli"
        traffic.write_line_list(tli, prob.tli, cfg, 11)
    model, fwd, _ = run.build_program(_Cell(cfg), tli, torch.device("cpu"))
    ref = Reference(load_problem(cfg, ROOT, tli), torch.device("cpu"))
    return ref, fwd, prob


def _profile(prob, k):
    tr = {"pool": 4, "t_modes": 3, "t_rel": 0.12, "t_range": [400, 2970],
          "q_dex": 0.5, "q_species": ["H2O", "CO", "CO2", "CH4"]}
    T, q = traffic.make_pool(prob.atm, tr, 5, torch.device("cpu"),
                             torch.float64)
    return T[k], q[k]


def _rel(a, b):
    return float((a - b).norm() / b.norm())


def test_spectrum_matches_port(pair):
    ref, fwd, prob = pair
    T, q = _profile(prob, 0)
    # float64 against float64: the exact mode's table is float32 in the
    # port, float64 here (~1e-9); fast mode is the same sum.
    assert _rel(fwd(T, q), ref.spectrum(T, q)) < 1e-8


def test_gradient_matches_port(pair):
    ref, fwd, prob = pair
    T, q = _profile(prob, 1)
    obs = ref.spectrum(T, q) * 1.05
    sigma = 0.01 * obs
    Tg, qg = T.clone().requires_grad_(), q.clone().requires_grad_()
    chi2 = (((fwd(Tg, qg) - obs) / sigma) ** 2).sum()
    gT, gq = torch.autograd.grad(chi2, (Tg, qg))
    _, rT, rq = ref.chi2_grad(T, q, obs, sigma)
    assert _rel(gT, rT) < 1e-7
    assert _rel(gq, rq) < 1e-6


def test_groups_match_native_partition(tmp_path):
    """The reference's vectorised co-add partition equals the port's
    native one, group for group, on the 25-way split of the slice."""
    from transit_tpu_torch import _native

    cfg = config("hj_exact_4m9", copies=25)
    prob = load_problem(cfg, ROOT)
    path = tmp_path / "lines.tli"
    traffic.write_line_list(path, prob.tli, cfg, 3)
    wl, iso, _, _ = load_problem(cfg, ROOT, path).lines
    wavn = 1.0 / (wl * 1e-4)
    c = cfg["transit"]
    wn0, dwn = c["wnlow"], c["wndelt"]
    nwn = int(((1.0 + 1e-8) * c["wnhigh"] - wn0) / dwn + 1)
    o = c["wnosamp"]
    owns = wn0 + np.arange((nwn - 1) * o + 1) * (dwn / o)
    mine = exact.groups(wavn, iso, wn0, dwn / o, dwn, owns.shape[0])
    theirs = _native.group_partition(wavn, iso.astype(np.int32), owns, wn0,
                                     dwn / o, dwn, float(owns[-1]))
    for a, b in zip(mine, theirs):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
