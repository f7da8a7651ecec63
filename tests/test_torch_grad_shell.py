"""The banded path's plain VJPs against torch autograd through its plain
forward, float64: plain_shell_vjp on the decimated bins-layout shells of
the fine-grid fixture (tests/test_torch_common.fine_grid_config), and
banded.plain_bands_vjp (every near class, stride-1 and decimated shell,
band by band) on the eclipse fixture and the fine grid, with and without
far_full_res.  Cotangents are compared chained to the tables' inputs
(T, densities, Z) at the bounds of JAX's own analytic-VJP test
(tests/test_fast_and_forward.py:377-408: rtol 1e-5, atol 1e-12 max): the
raw alphaD cotangent of the far wings is a sum of terms that cancel, and
rounding noise in any order of operations."""

import numpy as np
import pytest
import torch

from tests.test_conformance import make_config
from tests.test_torch_common import fine_grid_config, port_config
from transit_tpu_torch.model import TransitModel
from transit_tpu_torch.opacities import banded
from transit_tpu_torch.opacities.kernel_lbl import tile_cotangent
from transit_tpu_torch.opacities.kernel_shell import (plain_shell_tiles,
                                                      plain_shell_vjp,
                                                      upsample_cr_t,
                                                      _upsample_cr)

torch.set_num_threads(1)

TABLES = ("coef0", "densm", "alphal", "alphad_f")


@pytest.fixture(scope="module")
def fine():
    m = TransitModel(port_config(fine_grid_config()), dtype=torch.float64,
                     device="cpu", bands=6)
    assert any(fp.lanes == "bins" and s > 1 for far in m.bplan.far_plans
               if far for fp, _, s in far)
    return m


def _leaves(m):
    T = torch.tensor(m.atm.temp * m.atm.tfct, requires_grad=True)
    dens = torch.tensor(m.atm.d, requires_grad=True)
    Z = m.partition(m._t(m.atm.temp)).detach().requires_grad_(True)
    return T, dens, Z


def _tables(m, leaves):
    return banded.prep_layers(m.bdev[0], *leaves, m._molm_t, m._molrad_t,
                              use_kernel=False)


def _kw(m):
    return dict(wn_i=m.wns.i, dwn=m.wns.d, ethresh=m.cfg.ethreshold,
                nwidth=m.cfg.nwidth)


def _close(got, ref):
    for a, b in zip(got, ref):
        b = b.numpy()
        assert np.all(np.isfinite(a.numpy()))
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5,
                                   atol=1e-12 * np.abs(b).max())


def test_upsample_transpose():
    """upsample_cr_t is the transpose of _upsample_cr: <u(a), b> =
    <a, u^T(b)> on seeded random rows."""
    rng = np.random.default_rng(2)
    for stride, tw in ((2, 16), (4, 64), (16, 512)):
        a = torch.as_tensor(rng.standard_normal((3, 5, tw // stride + 3)))
        b = torch.as_tensor(rng.standard_normal((3, 5, tw)))
        lhs = (_upsample_cr(a, stride, tw) * b).sum()
        rhs = (a * upsample_cr_t(b, stride, tw)).sum()
        assert abs(float(lhs - rhs)) <= 1e-12 * float(lhs.abs())


def test_shell_vjp_matches_autograd(fine):
    """plain_shell_vjp against autograd through plain_shell_tiles, class by
    class, for every decimated shell of the fine grid (strides 2-16,
    asym2, the clip at 0 per shell)."""
    m, kw = fine, _kw(fine)
    n = 0
    for _, rows, part, plan, classes, stride in banded.band_parts(m.bplan,
                                                                  m.bdev):
        if part != "shell":
            continue
        sel = torch.as_tensor(rows)
        for dc, gidx in classes:
            leaves = _leaves(m)
            tab = {k: v[sel] for k, v in _tables(m, leaves).items()}
            out = plain_shell_tiles(plan, dc, tab, leaves[0][sel],
                                    stride=stride, gidx=gidx, **kw)
            g = torch.as_tensor(np.random.default_rng(n).standard_normal(
                out.shape))
            ref = torch.autograd.grad((out * g).sum(), leaves)
            leaves = _leaves(m)
            tab = {k: v[sel] for k, v in _tables(m, leaves).items()}
            T = leaves[0][sel]
            grads = plain_shell_vjp(plan, dc, {k: v.detach() for k, v in
                                               tab.items()}, T.detach(), g,
                                    stride=stride, gidx=gidx, **kw)
            got = torch.autograd.grad(
                [T] + [tab[k] for k in TABLES], leaves,
                [grads["temps"]] + [grads[k] for k in TABLES])
            _close(got, ref)
            n += 1
    assert n >= 4


@pytest.mark.parametrize("config,far_full_res", [
    ("fixture", False), ("fine", False), ("fine", True)])
def test_banded_vjp_matches_autograd(fine, config, far_full_res):
    """banded.plain_bands_vjp (the VJP the model's LineExtinction takes
    on the CPU) against autograd through plain_banded_extinction, the
    whole banded function, on a seeded random cotangent."""
    m = fine if config == "fine" else TransitModel(
        port_config(make_config("eclipse", 1e30)), dtype=torch.float64,
        device="cpu", bands=6)
    kw = _kw(m)
    leaves = _leaves(m)
    out = banded.plain_banded_extinction(m.bplan, m.bdev, *leaves,
                                         m._molm_t, m._molrad_t,
                                         far_full_res=far_full_res, **kw)
    g = torch.as_tensor(np.random.default_rng(9).standard_normal(out.shape))
    ref = torch.autograd.grad((out * g).sum(), leaves)
    leaves = _leaves(m)
    tab = _tables(m, leaves)
    grads = banded.plain_bands_vjp(
        m.bplan, m.bdev, {k: v.detach() for k, v in tab.items()},
        leaves[0].detach(), g, kw, far_full_res)
    got = torch.autograd.grad([leaves[0]] + [tab[k] for k in TABLES],
                              leaves, [grads["temps"]] +
                              [grads[k] for k in TABLES])
    _close(got, ref)
    # The plan's last tile reaches past n_coarse: its cotangent there is 0.
    p = m.bplan.plans[0]
    assert tile_cotangent(g, p).shape == (20, p.ntiles, p.tw)


def test_model_line_extinction_gradient(fine):
    """The model's line extinction (LineExtinction on the CPU: plain
    forward, plain VJPs) against autograd through
    plain_banded_extinction, the same cotangent: the forward bit for bit,
    the gradient in (T, densities, Z) at the bounds above."""
    m, kw = fine, _kw(fine)
    leaves = _leaves(m)
    ref_out = banded.plain_banded_extinction(m.bplan, m.bdev, *leaves,
                                             m._molm_t, m._molrad_t, **kw)
    g = torch.as_tensor(np.random.default_rng(5).standard_normal(
        ref_out.shape))
    ref = torch.autograd.grad((ref_out * g).sum(), leaves)
    leaves = _leaves(m)
    out = m.line_extinction(*leaves)
    assert torch.equal(out.detach(), ref_out.detach())
    _close(torch.autograd.grad((out * g).sum(), leaves), ref)
