"""The port's CUDA kernels on the card: marked ``cuda``, skipped without
one.  Imports no JAX, so it runs on a machine that has only PyTorch:

    python -m pytest -m cuda --noconftest tests/test_torch_cuda.py -q

(``--noconftest``: the suite's conftest.py imports JAX.)
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from transit_tpu_torch.config import TransitConfig
from transit_tpu_torch.model import TransitModel
from transit_tpu_torch.opacities import fast
from transit_tpu_torch.opacities.kernel_lbl import (
    kernel_extinction, layer_kmax, layer_tables, line_tile_extinction,
    plain_extinction, plain_kmax, run_counts, strength_coef)

torch.set_num_threads(1)

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _config(**kw):
    return TransitConfig(
        atm=f"{FIX}/test.atm", linedb=f"{FIX}/test.tli",
        csfile=f"{FIX}/test_cia.dat", molfile=f"{FIX}/molecules.dat",
        wnlow=2000.0, wnhigh=2100.0, wndelt=1.0, wnosamp=216, wnfct=1.0,
        nwidth=20.0, ethreshold=1e-8, solution="eclipse", toomuch=1e30,
        **kw)


def _model(device, dtype=torch.float32, mode="fast", **kw):
    return TransitModel(_config(), mode=mode, dtype=dtype, device=device,
                        **kw)


def _state(m):
    t = m._t(m.atm.temp)
    return ((t * m.atm.tfct, m._t(m.atm.d), m.partition(t), m._molm_t,
             m._molrad_t),
            dict(wn_i=m.wns.i, dwn=m.wns.d, ethresh=m.cfg.ethreshold,
                 nwidth=m.cfg.nwidth))


@pytest.mark.cuda
def test_kernel_matches_plain_on_card(card):
    m = _model(card)
    args, kw = _state(m)
    before = line_tile_extinction.launches
    b = kernel_extinction(m.fplan, m.fdev, *args, **kw)
    a = plain_extinction(m.fplan, m.fdev, *args, **kw)
    torch.cuda.synchronize()
    assert line_tile_extinction.launches == before + 1
    rel = (a - b).abs() / (a.abs() + 1e-6 * a.abs().max())
    assert float(rel.max()) < 1e-5


@pytest.mark.cuda
def test_kernel_refuses_float64(card):
    m = _model(card, torch.float64)
    args, kw = _state(m)
    with pytest.raises(TypeError, match="float32"):
        kernel_extinction(m.fplan, m.fdev, *args, **kw)


@pytest.mark.cuda
def test_forward_through_kernel_on_card(card):
    m = _model(card)
    before = line_tile_extinction.launches
    s = m.forward(m.atm.temp, m.atm.q)
    m.use_kernel = False
    p = m.forward(m.atm.temp, m.atm.q)
    assert line_tile_extinction.launches == before + 1
    assert bool(torch.isfinite(s).all())
    assert float(((s - p).abs() / p.abs()).max()) < 1e-4


@pytest.mark.cuda
def test_zero_live_lines_on_card(card):
    m = _model(card)
    args, kw = _state(m)
    d = dict(m.fdev, mask=torch.zeros_like(m.fdev["mask"]))
    tab = layer_tables(d, *args)
    out = line_tile_extinction(m.fplan, d, tab, args[0], **kw)
    assert int(torch.count_nonzero(out)) == 0


def _kernel_vs_plain(m, args, kw):
    """Kernel and plain version on the same state: max relative error
    (the bound of tests/test_pallas.py:35) and the kernel's counters
    against the host count of its design (run_counts)."""
    before = (line_tile_extinction.launches, layer_kmax.launches)
    b = kernel_extinction(m.fplan, m.fdev, *args, **kw)
    a = plain_extinction(m.fplan, m.fdev, *args, **kw)
    assert (line_tile_extinction.launches, layer_kmax.launches) == \
        (before[0] + 1, before[1] + 1)
    tab = layer_tables(m.fdev, *args)
    stats = torch.zeros(3, dtype=torch.int64, device=a.device)
    c = line_tile_extinction(m.fplan, m.fdev, tab, args[0], **kw,
                             stats=stats)
    torch.cuda.synchronize()
    assert torch.equal(b, c)
    host = run_counts(m.fplan, m.fdev, tab, args[0], **kw)
    assert dict(zip(("chains", "live", "pairs"), stats.tolist())) == host
    assert b.shape == a.shape == (args[0].shape[0], m.wns.n)
    rel = (a - b).abs() / (a.abs() + 1e-6 * a.abs().max())
    return float(rel.max()) if a.numel() else 0.0, host


@pytest.mark.cuda
def test_layer_kmax_equals_plain_bitwise(card):
    m = _model(card)
    args, _ = _state(m)
    coef0 = strength_coef(m.fdev, args[2])
    before = layer_kmax.launches
    got = layer_kmax(m.fdev, args[0], coef0)
    want = plain_kmax(m.fdev, args[0], coef0)
    torch.cuda.synchronize()
    assert layer_kmax.launches == before + 1
    assert torch.isfinite(want).all() and torch.equal(got, want)


@pytest.mark.cuda
def test_kernel_wide_wing_in_rounds(card):
    """A wing far wider than the plan's halo: every kept line covers its
    whole tile, so a chunk holds more (bin, line) pairs than one round
    of shared memory (20 layers x 96 lines x 8 bins > 4096)."""
    m = _model(card)
    args, kw = _state(m)
    kw["nwidth"] = 1e5
    rel, host = _kernel_vs_plain(m, args, kw)
    assert rel < 1e-5
    assert host["pairs"] == host["live"] * m.fplan.tw


@pytest.mark.cuda
def test_kernel_ragged_layer_count(card):
    m = _model(card)
    (T, dens, Z, mm, mr), kw = _state(m)
    rel, host = _kernel_vs_plain(m, (T[:7], dens[:, :7], Z[:, :7], mm, mr),
                                 kw)
    assert rel < 1e-5 and host["pairs"] > 0


@pytest.mark.cuda
def test_kernel_every_line_cut_by_ethresh(card):
    """ethresh above 1 drops every line (k0 < ethresh * kmax)."""
    m = _model(card)
    args, kw = _state(m)
    kw["ethresh"] = 2.0
    out = kernel_extinction(m.fplan, m.fdev, *args, **kw)
    assert int(torch.count_nonzero(out)) == 0
    tab = layer_tables(m.fdev, *args)
    assert run_counts(m.fplan, m.fdev, tab, args[0], **kw)["live"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("tw", [64, 256])
def test_kernel_wide_tiles(card, tw):
    """Other tile widths than the fixture's 8: fewer layers per block,
    longer chunks, and (tw 256) one ragged tile of 101 bins."""
    m = _model(card)
    p = m.fplan
    mw = fast.max_width_bound(m.atm, m.mol, m.iso.mass, m.wns.f,
                              m.iso.imol)
    m.fplan = fast.make_fast_plan(p.wavn, p.isoid, p.elow, p.gf,
                                  wn_i=m.wns.i, dwn=m.wns.d,
                                  n_coarse=m.wns.n, max_width=mw,
                                  nwidth=m.cfg.nwidth, tw=tw)
    m.fdev = {**m.fdev, **fast.fast_device_arrays(m.fplan, m.iso,
                                                  dtype=torch.float32,
                                                  device=card)}
    args, kw = _state(m)
    rel, host = _kernel_vs_plain(m, args, kw)
    assert rel < 1e-5 and host["pairs"] > 0


# --- The banded path (opacities/banded.py) ---------------------------------

def _fine_model(device, **kw):
    """The fine-grid fixture configuration (tests/test_fast_and_forward.py
    :261) with bands=6: tile widths up to 512, decimated asym2 shells with
    lanes="bins" (lmax 8 and up) and tile classes, a stride-1 r2 shell."""
    cfg = TransitConfig(
        atm=f"{FIX}/test.atm", linedb=f"{FIX}/test.tli",
        csfile=f"{FIX}/test_cia.dat", molfile=f"{FIX}/molecules.dat",
        wnlow=2000.0, wnhigh=2040.0, wndelt=0.01, wnosamp=2, wnfct=1.0,
        nwidth=20.0, ethreshold=1e-8, solution="eclipse", toomuch=1e30)
    return TransitModel(cfg, mode="fast", dtype=torch.float32, device=device,
                        bands=6, **kw)


def _rel(a, b):
    """max |a-b| / (|a| + 1e-6 max|a|); an all-zero reference must be
    matched exactly."""
    if not bool(a.any()):
        return 0.0 if not bool(b.any()) else float("inf")
    return float(((a - b).abs() / (a.abs() + 1e-6 * a.abs().max())).max())


def _scatter_plain(out, plan, gidx, sel, val, add):
    """Write (or add) a line-tile launch's plain (nrows, ntiles_c, tw)
    block into out."""
    g = (torch.arange(plan.ntiles, device=out.device) if gidx is None else
         torch.as_tensor(gidx).long().to(out.device))
    cols = (g[:, None] * plan.tw +
            torch.arange(plan.tw, device=out.device)).flatten()
    keep = cols < out.shape[1]
    r, c = sel[:, None], cols[keep][None, :]
    v = val.reshape(sel.shape[0], -1)[:, keep]
    out[r, c] = out[r, c] + v if add else v


def _parts(m, args, kw, far_full_res=False):
    """Each launch of the banded path on its own, into a zero output, and
    its plain version on the band's rows: yields (part, plans, kernel,
    plain), both (nrows, n_coarse) on the band's rows."""
    from transit_tpu_torch.opacities import banded
    from transit_tpu_torch.opacities.kernel_lbl import plain_line_tiles
    from transit_tpu_torch.opacities.kernel_shell import (
        plain_shell_band, shell_tile_extinction)
    tab = banded.prep_layers(m.bdev[0], *args, use_kernel=True)
    index = banded.banded_index(m.bplan, m.bdev, args[0].device)
    for i, part, unit in banded.launch_units(m.bplan, m.bdev, index):
        r = index["rows"][i]
        sel = r.long()
        got = torch.zeros((args[0].shape[0], m.wns.n), device=r.device)
        want = torch.zeros_like(got)
        if part == "shell":
            shell_tile_extinction(unit, tab, args[0], rows=r, out=got,
                                  full_res=far_full_res, **kw)
            plain_shell_band(unit, tab, args[0], rows=r, out=want,
                             full_res=far_full_res, **kw)
            plans = [p for p, _, _ in unit.parts]
        else:
            plan, dc, gidx, t = unit
            line_tile_extinction(plan, dc, tab, args[0], tiles=t, rows=r,
                                 out=got, accumulate=part == "s1",
                                 bins_first=True, **kw)
            val = plain_line_tiles(plan, dc,
                                   {k: v[sel] for k, v in tab.items()},
                                   args[0][sel], gidx=gidx,
                                   bins_first=True, **kw)
            _scatter_plain(want, plan, gidx, sel, val, part == "s1")
            plans = [plan]
        yield part, plans, got[sel], want[sel]


@pytest.mark.cuda
@pytest.mark.parametrize("config", ["fixture", "fine"])
def test_banded_launches_match_plain(card, config):
    """Every launch of the banded path — near classes, stride-1 shells
    (accumulate, r2), decimated shells (asym2, lanes="bins" lmax 8,
    classes), tw 512, on the band's layer rows — against its plain
    version."""
    m = (_model(card, bands=6) if config == "fixture" else
         _fine_model(card))
    args, kw = _state(m)
    seen = set()
    for part, plans, got, want in _parts(m, args, kw):
        assert got.shape == want.shape
        assert _rel(want, got) < 1e-5, (part, plans[0].tw,
                                         plans[0].wfn_tag)
        seen.update((part, p.tw, p.wfn_tag, p.lanes, p.lmax) for p in plans)
    if config == "fine":
        assert any(s[1] == 512 for s in seen)
        assert any(s[0] == "shell" and s[3] == "bins" and s[4] == 8
                   for s in seen)
        assert any(s[0] == "s1" for s in seen)


@pytest.mark.cuda
def test_shell_kernel_full_resolution(card):
    """far_full_res: the decimated shells evaluated at stride 1 with the
    same weighting (no upsampling), kernel against plain."""
    m = _fine_model(card)
    args, kw = _state(m)
    n = 0
    for part, _, got, want in _parts(m, args, kw, far_full_res=True):
        assert _rel(want, got) < 1e-5
        n += part == "shell"
    assert n > 0


@pytest.mark.cuda
@pytest.mark.parametrize("config", ["fixture", "fine"])
def test_banded_forward_on_card(card, config):
    """The banded model's forward through the kernels against its plain
    path, and the kernels' counters against the host count of their
    work."""
    from transit_tpu_torch.opacities import banded
    from transit_tpu_torch.opacities.kernel_shell import (
        shell_tile_extinction)
    m = (_model(card, bands=6) if config == "fixture" else
         _fine_model(card))
    before = (line_tile_extinction.launches, layer_kmax.launches,
              shell_tile_extinction.launches)
    s = m.forward(m.atm.temp, m.atm.q)
    torch.cuda.synchronize()
    after = (line_tile_extinction.launches, layer_kmax.launches,
             shell_tile_extinction.launches)
    assert after[1] == before[1] + 1 and after[0] > before[0]
    assert (after[2] > before[2]) == (config == "fine")
    m.use_kernel = False
    p = m.forward(m.atm.temp, m.atm.q)
    assert bool(torch.isfinite(s).all())
    assert float(((s - p).abs() / p.abs()).max()) < 1e-4
    args, kw = _state(m)
    stats = {k: torch.zeros(3, dtype=torch.int64, device=card)
             for k in ("line_tile", "shell")}
    banded.banded_kernel_extinction(m.bplan, m.bdev, *args, stats=stats,
                                    **kw)
    tab = banded.prep_layers(m.bdev[0], *args, use_kernel=True)
    host = banded.banded_counts(m.bplan, m.bdev, tab, args[0], **kw)
    assert dict(zip(("chains", "live", "pairs"),
                    stats["line_tile"].tolist())) == host["line_tile"]
    assert dict(zip(("chains", "live", "evals"),
                    stats["shell"].tolist())) == host["shell"]


@pytest.mark.cuda
def test_layer_kmax_floor_zero(card):
    m = _model(card)
    args, _ = _state(m)
    coef0 = strength_coef(m.fdev, args[2])
    d = {**m.fdev, **{k: m.fdev[k][:1] for k in
                      ("all_wavn", "all_elow", "all_gf", "all_iso")}}
    d["all_gf"] = torch.zeros_like(d["all_gf"]) - 1.0   # k0 < 0
    got = layer_kmax(d, args[0], coef0, floor=0.0)
    assert torch.equal(got, plain_kmax(d, args[0], coef0, floor=0.0))
    assert torch.count_nonzero(got) == 0


def _grad_rel(got: dict, want: dict) -> float:
    """max over the outputs of max|a - b| / max|b| (an all-zero reference
    must be matched exactly)."""
    worst = 0.0
    for k, b in want.items():
        a = got[k].to(b.dtype)
        assert torch.isfinite(a).all(), k
        scale = float(b.abs().max())
        diff = float((a - b).abs().max())
        worst = max(worst, diff / scale if scale > 0 else
                    (0.0 if diff == 0 else float("inf")))
    return worst


@pytest.mark.cuda
@pytest.mark.parametrize("config", ["fixture", "fixture_bands6", "fine"])
def test_kernel_gradients_match_plain_vjps(card, config):
    """The gradient through the kernels (LineExtinction: the forward
    kernels, then line_tile_backward / shell_tile_backward) equals the
    plain path's (plain forward, plain VJPs) on the card, in (T,
    densities, Z), on a seeded cotangent; the backward kernels ran."""
    from transit_tpu_torch.opacities.kernel_lbl import line_tile_backward
    from transit_tpu_torch.opacities.kernel_shell import shell_tile_backward
    m = (_fine_model(card) if config == "fine" else
         _model(card, bands=6 if config == "fixture_bands6" else 0))
    args, _ = _state(m)
    rng = np.random.default_rng(8)
    g = torch.as_tensor(rng.standard_normal((20, m.wns.n)),
                        dtype=torch.float32, device=card)
    res = []
    before = line_tile_backward.launches + shell_tile_backward.launches
    for use_kernel in (True, False):
        m.use_kernel = use_kernel
        leaves = [a.clone().requires_grad_(True) for a in args[:3]]
        ex = m.line_extinction(*leaves)
        res.append(dict(zip(("T", "dens", "Z"), torch.autograd.grad(
            (ex * g).sum(), leaves))))
    torch.cuda.synchronize()
    assert line_tile_backward.launches + shell_tile_backward.launches > \
        before
    assert _grad_rel(res[0], res[1]) < 1e-4


def _batch_vs_loop(m, card, seed):
    """forward_batch (B = 2) against a loop of forward: spectra <= 1e-6
    relative, gradients < 1e-4 of max; returns the launches of the
    batched step alone: (line_tile_extinction, shell_tile_extinction) of
    forward_batch and (line_tile_backward, shell_tile_backward) of its
    gradient."""
    from transit_tpu_torch.opacities.kernel_lbl import (
        line_tile_backward, line_tile_extinction)
    from transit_tpu_torch.opacities.kernel_shell import (
        shell_tile_backward, shell_tile_extinction)
    rng = np.random.default_rng(seed)
    T0 = np.asarray(m.atm.temp, dtype=np.float64)
    q0 = np.asarray(m.atm.q, dtype=np.float64)
    Tb = np.stack([T0, T0 + rng.normal(0.0, 30.0, T0.shape)])
    qb = np.stack([q0, q0 * (1.0 + 0.1 * rng.uniform(-1, 1, q0.shape))])

    def leaves(t, qq):
        return tuple(torch.tensor(a, dtype=torch.float32, device=card,
                                  requires_grad=True) for a in (t, qq))

    T, q = leaves(Tb, qb)
    before = (line_tile_extinction.launches, shell_tile_extinction.launches)
    spec = m.forward_batch(T, q)
    fwd = (line_tile_extinction.launches - before[0],
           shell_tile_extinction.launches - before[1])
    before = (line_tile_backward.launches, shell_tile_backward.launches)
    grads = torch.autograd.grad(spec.sum(), (T, q))
    torch.cuda.synchronize()
    bwd = (line_tile_backward.launches - before[0],
           shell_tile_backward.launches - before[1])
    loop, lgrads = [], []
    for i in range(2):
        t, qq = leaves(Tb[i], qb[i])
        s = m.forward(t, qq)
        loop.append(s.detach())
        lgrads.append(torch.autograd.grad(s.sum(), (t, qq)))
    loop = torch.stack(loop)
    assert spec.shape == loop.shape and bool(torch.isfinite(spec).all())
    assert float(((spec.detach() - loop).abs() / loop.abs()).max()) <= 1e-6
    for a, b in zip(grads, (torch.stack(g) for g in zip(*lgrads))):
        assert bool(torch.isfinite(a).all()) and float(b.abs().max()) > 0
        assert float((a - b).abs().max() / b.abs().max()) < 1e-4
    return fwd, bwd


@pytest.mark.cuda
def test_forward_batch_fine_grid_on_card(card):
    """forward_batch (B = 2) on the fine-grid fixture with bands=6 runs
    the decimated shells over the batch's pseudo-layers (the batched
    view's shell bands with its own rows, clip masks sized from those
    rows, shell_tile_backward over 2 x 20 rows): its spectra against a
    loop of forward <= 1e-6 relative, its gradient against the loop's <
    1e-4 of max."""
    m = _fine_model(card)
    (fwd_lines, fwd_shells), (lines, shells) = _batch_vs_loop(m, card, 12)
    assert fwd_lines > 0 and fwd_shells > 0 and shells > 0
    assert lines == len(m.bplan.plans)


@pytest.mark.cuda
def test_forward_batch_fixture_bands6_on_card(card):
    """forward_batch (B = 2) on the fixture with bands=6: the batched
    gradient runs one line_tile_backward launch per band over the class
    table on the batch's rows; spectra and gradient as the loop's."""
    m = _model(card, bands=6)
    (fwd_lines, fwd_shells), (lines, shells) = _batch_vs_loop(m, card, 13)
    assert fwd_lines > 0 and fwd_shells == 0
    assert (lines, shells) == (len(m.bplan.plans), 0)


def _line_bwd_vs_plain(units, tab, temps, g, kw, rows, bins_first=False):
    """One line_tile_backward launch over the classes ``units`` [(plan,
    line tensors, int32 tiles or None, global tiles (numpy) or None)] on
    ``rows`` against the sum of their plain_line_tiles_vjp on the same
    rows: max relative error over the outputs; the kernel's sums outside
    the rows stay 0."""
    from transit_tpu_torch.opacities.kernel_lbl import (
        LineBand, acc_grads, line_tile_backward, plain_line_tiles_vjp,
        tile_cotangent, zero_grads)
    acc = line_tile_backward(LineBand([(p, d, gidx, t)
                                       for p, d, t, gidx in units]),
                             tab, temps, g, rows=rows, bins_first=bins_first,
                             **kw)
    torch.cuda.synchronize()
    sel = rows.long()
    others = torch.ones(temps.shape[0], dtype=torch.bool, device=g.device)
    others[sel] = False
    assert int(torch.count_nonzero(acc[others])) == 0
    tab_r = {k: v[sel] for k, v in tab.items()}
    want = zero_grads(tab_r, temps[sel])
    for plan, d, _, gidx in units:
        gt = tile_cotangent(g[sel], plan)
        plain_line_tiles_vjp(plan, d, tab_r, temps[sel],
                             gt if gidx is None else gt[:, (
                                 torch.as_tensor(gidx).long())],
                             gidx=gidx, bins_first=bins_first, grads=want,
                             **kw)
    got = {k: v[sel] for k, v in acc_grads(acc, torch.float64).items()}
    return _grad_rel(got, want)


def _wide_plan(m, card, tw):
    """The fixture's unbanded plan re-planned at tile width ``tw``."""
    p = m.fplan
    mw = fast.max_width_bound(m.atm, m.mol, m.iso.mass, m.wns.f,
                              m.iso.imol)
    plan = fast.make_fast_plan(p.wavn, p.isoid, p.elow, p.gf, wn_i=m.wns.i,
                               dwn=m.wns.d, n_coarse=m.wns.n, max_width=mw,
                               nwidth=m.cfg.nwidth, tw=tw)
    return plan, {**m.fdev, **fast.fast_device_arrays(
        plan, m.iso, dtype=torch.float32, device=card)}


@pytest.mark.cuda
@pytest.mark.parametrize("nrows", [1, 7, 101])
@pytest.mark.parametrize("tw", [8, 64, 512])
def test_line_backward_layers_and_widths(card, tw, nrows):
    """line_tile_backward against its plain VJP at tile widths 8 (the
    fixture's), 64 and 512 (one tile, ragged against 101 bins), on 1, 7
    and 101 layer rows (the fixture's 20 layers' tables cycled to 120
    rows: ragged layer blocks)."""
    m = _model(card)
    plan, d = (m.fplan, m.fdev) if tw == 8 else _wide_plan(m, card, tw)
    args, kw = _state(m)
    tab = layer_tables(d, *args)
    idx = torch.arange(120, device=card) % 20
    tab = {k: v[idx].contiguous() for k, v in tab.items()}
    temps = args[0][idx].contiguous()
    rows = torch.arange(7, 7 + nrows, dtype=torch.int32, device=card)
    g = torch.as_tensor(np.random.default_rng(nrows).standard_normal(
        (120, m.wns.n)), dtype=torch.float32, device=card)
    assert _line_bwd_vs_plain([(plan, d, None, None)], tab, temps, g, kw,
                              rows) < 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["empty_tiles", "ethresh_cuts_all"])
def test_line_backward_empty_and_cut(card, case):
    """Tiles with no line (the mask cleared on every other tile) give
    those tiles no cotangent; ethresh above 1 cuts every line: all
    cotangents 0, as the plain VJP's."""
    m = _model(card)
    args, kw = _state(m)
    d = dict(m.fdev)
    if case == "empty_tiles":
        d["mask"] = d["mask"].clone()
        d["mask"][::2] = False
    else:
        kw["ethresh"] = 2.0
    tab = layer_tables(d, *args)
    g = torch.ones((20, m.wns.n), device=card)
    rows = torch.arange(20, dtype=torch.int32, device=card)
    assert _line_bwd_vs_plain([(m.fplan, d, None, None)], tab, args[0], g,
                              kw, rows) < 1e-4
    from transit_tpu_torch.opacities.kernel_lbl import (LineBand,
                                                        line_tile_backward)
    acc = line_tile_backward(LineBand([(m.fplan, d, None, None)]), tab,
                             args[0], g, **kw)
    assert (int(torch.count_nonzero(acc)) == 0) == (case ==
                                                     "ethresh_cuts_all")


def _band_line_backward(m, seed):
    """Every line_tile_backward launch of a banded model (one per band,
    over its near and stride-1 classes) against its plain VJPs: the
    worst relative error, and the number of launches."""
    from transit_tpu_torch.opacities import banded
    args, kw = _state(m)
    tab = banded.prep_layers(m.bdev[0], *args, use_kernel=True)
    g = torch.as_tensor(np.random.default_rng(seed).standard_normal(
        (20, m.wns.n)), dtype=torch.float32, device=args[0].device)
    worst, n = 0.0, 0
    for i, part, unit in banded.backward_units(m.bplan, m.bdev, m.bindex):
        if part != "lines":
            continue
        worst = max(worst, _line_bwd_vs_plain(
            [(p, dc, t, gidx) for p, dc, gidx, t in unit.units], tab,
            args[0], g, kw, m.bindex["rows"][i], bins_first=True))
        n += 1
    return worst, n


@pytest.mark.cuda
def test_banded_line_backward_launches(card):
    """Every line_tile_backward launch of the fine grid's banded path
    (one per band over its tile classes, tw up to 512, bins_first)
    against its plain VJPs."""
    m = _fine_model(card)
    worst, n = _band_line_backward(m, 3)
    assert worst < 1e-4 and n == len(m.bplan.plans)


@pytest.mark.cuda
def test_banded_line_backward_launches_fixture(card):
    """The same on the fixture with bands=6 (near classes and stride-1
    shells, tw 8)."""
    m = _model(card, bands=6)
    worst, n = _band_line_backward(m, 4)
    assert worst < 1e-4 and n == len(m.bplan.plans)


@pytest.mark.cuda
def test_banded_shell_backward_launches(card):
    """Every shell_tile_backward launch of the fine grid's banded path
    (one per band with decimated shells, its forward launch's clip mask)
    against its plain VJPs."""
    m = _fine_model(card)
    args, kw = _state(m)
    from transit_tpu_torch.opacities import banded
    tab = banded.prep_layers(m.bdev[0], *args, use_kernel=True)
    n = 0
    for i, part, unit in banded.backward_units(m.bplan, m.bdev, m.bindex):
        if part == "shell":
            assert _shell_bwd_vs_plain(unit, tab, args[0], kw,
                                       m.bindex["rows"][i]) < 1e-4
            n += 1
    assert n == sum(b is not None for b in m.bindex["shells"]) > 0


# --- The shell kernel's launch (one per band) and layer_kmax ---------------

def _band_state(m):
    """The fine-grid model's band-0 decimated shells [(plan, classes,
    stride)] (tw 512, 8 tiles), and the prep tables of all its layers."""
    from transit_tpu_torch.opacities import banded
    args, kw = _state(m)
    tab = banded.prep_layers(m.bdev[0], *args, use_kernel=True)
    parts = [(p, c, s) for i, _, part, p, c, s in
             banded.band_parts(m.bplan, m.bdev) if i == 0 and
             part == "shell"]
    return parts, tab, args[0], kw


def _shell_vs_plain(band, tab, temps, kw, rows, full_res=False):
    """Kernel and plain version of one shell launch on the same output
    (zero on the rows, seeded random values elsewhere, which must stay
    as they were), and the kernel's counters against shell_counts: max
    relative error over the rows."""
    from transit_tpu_torch.opacities.kernel_shell import (
        plain_shell_band, shell_counts, shell_tile_extinction)
    sel = rows.long()
    others = torch.ones(temps.shape[0], dtype=torch.bool,
                        device=temps.device)
    others[sel] = False
    rng = np.random.default_rng(7)
    base = torch.as_tensor(rng.uniform(0.0, 1e-3, (temps.shape[0],
                                                   band.parts[0][0].n_coarse)),
                           dtype=torch.float32, device=temps.device)
    base[sel] = 0.0
    got, want = base.clone(), base.clone()
    stats = torch.zeros(3, dtype=torch.int64, device=temps.device)
    before = shell_tile_extinction.launches
    shell_tile_extinction(band, tab, temps, rows=rows, out=got, stats=stats,
                          full_res=full_res, **kw)
    plain_shell_band(band, tab, temps, rows=rows, out=want,
                     full_res=full_res, **kw)
    torch.cuda.synchronize()
    assert shell_tile_extinction.launches == before + 1
    host = {"chains": 0, "live": 0, "evals": 0}
    tab_r = {k: v[sel] for k, v in tab.items()}
    for plan, classes, stride in band.parts:
        for dc, gidx in classes:
            c = shell_counts(plan, dc, tab_r, temps[sel],
                             stride=1 if full_res else stride, gidx=gidx,
                             **kw)
            for k, v in c.items():
                host[k] += v
    assert dict(zip(("chains", "live", "evals"), stats.tolist())) == host
    assert host["evals"] > 0
    assert torch.equal(got[others], base[others])
    assert float(want[sel].max()) > 0
    return _rel(want[sel], got[sel])


@pytest.mark.cuda
@pytest.mark.parametrize("nrows", [1, 5, 6, 7])
@pytest.mark.parametrize("wfn", ["r2", "asym2"])
@pytest.mark.parametrize("stride", [2, 4, 8])
def test_shell_kernel_matches_plain(card, stride, wfn, nrows):
    """One shell launch (the fine grid's band-0 shells at tw 512, all
    with Voigt function ``wfn`` at ``stride``) on ``nrows`` layer rows
    against its plain version; rows outside are left as they were."""
    import dataclasses
    from transit_tpu_torch.opacities.kernel_shell import shell_band
    parts, tab, temps, kw = _band_state(_fine_model(card))
    band = shell_band([(dataclasses.replace(p, wfn_tag=wfn), c, stride)
                       for p, c, _ in parts[:2]])
    rows = torch.arange(3, 3 + nrows, dtype=torch.int32, device=card)
    assert _shell_vs_plain(band, tab, temps, kw, rows) < 1e-5


def _dense_class(plan, classes, tiles_long, reps, empty):
    """One class (row i = tile i) of a shell with the lines of the tiles
    ``tiles_long`` repeated ``reps`` times and no line in the tiles
    ``empty``."""
    rows = {}
    for dc, gidx in classes:
        g = range(plan.ntiles) if gidx is None else gidx
        for r, t in enumerate(g):
            n = int(dc["mask"][r].sum())
            rows[int(t)] = {k: dc[k][r, :n] for k in
                            ("wavn", "elow", "gf", "iso")}
    for t in tiles_long:
        rows[t] = {k: v.repeat(reps) for k, v in rows[t].items()}
    for t in empty:
        rows[t] = {k: v[:0] for k, v in rows[t].items()}
    lmax = max(v["wavn"].shape[0] for v in rows.values())
    d = {}
    for k in ("wavn", "elow", "gf", "iso"):
        # Padding repeats a real line, as the planner's tile tensors do.
        d[k] = rows[tiles_long[0]][k][0].repeat(plan.ntiles, lmax)
        for t, v in rows.items():
            d[k][t, :v[k].shape[0]] = v[k]
    n = torch.tensor([rows[t]["wavn"].shape[0] for t in range(plan.ntiles)],
                     device=d["wavn"].device)
    d["mask"] = (torch.arange(lmax, device=n.device)[None, :] <
                 n[:, None])
    return [(d, None)]


@pytest.mark.cuda
@pytest.mark.parametrize("nrows", [1, 7])
def test_shell_kernel_empty_and_long_tiles(card, nrows):
    """A tile with no line in the first shell, a tile with no line in any
    shell (no block: left as it was), and a tile with more lines than one
    staged chunk holds (600-1400 > 512 lines), kernel against plain."""
    from transit_tpu_torch.opacities.kernel_shell import shell_band
    parts, tab, temps, kw = _band_state(_fine_model(card))
    (p0, c0, s0), (p1, c1, s1) = parts[:2]
    band = shell_band([
        (p0, _dense_class(p0, c0, [0], 100, [2, 5]), s0),
        (p1, _dense_class(p1, c1, [0, 3], 100, [5]), s1)])
    table = band.blocks.cpu().numpy()
    assert 5 not in table[:, 0] and 2 in table[:, 0]
    assert table[:, 2::2].max() > 512
    rows = torch.arange(nrows, dtype=torch.int32, device=card)
    assert _shell_vs_plain(band, tab, temps, kw, rows) < 1e-5
    assert _shell_vs_plain(band, tab, temps, kw, rows, full_res=True) < 1e-5


def _shell_bwd_vs_plain(band, tab, temps, kw, rows, full_res=False):
    """shell_tile_backward (with the clip mask of its forward launch)
    against plain_shell_vjp, shell by shell, on the same rows and a
    seeded cotangent: max relative error over the outputs."""
    from transit_tpu_torch.opacities.kernel_lbl import (acc_grads,
                                                        tile_cotangent,
                                                        zero_grads)
    from transit_tpu_torch.opacities.kernel_shell import (
        plain_shell_vjp, shell_tile_backward, shell_tile_extinction)
    n = band.parts[0][0].n_coarse
    clip = torch.zeros((len(band.parts), rows.shape[0], n),
                       dtype=torch.uint8, device=temps.device)
    shell_tile_extinction(band, tab, temps, rows=rows, clip=clip,
                          full_res=full_res,
                          out=torch.zeros((temps.shape[0], n),
                                          device=temps.device), **kw)
    g = torch.as_tensor(np.random.default_rng(rows.shape[0])
                        .standard_normal((temps.shape[0], n)),
                        dtype=torch.float32, device=temps.device)
    acc = shell_tile_backward(band, tab, temps, g, rows=rows,
                              clip=None if full_res else clip,
                              full_res=full_res, **kw)
    torch.cuda.synchronize()
    sel = rows.long()
    tab_r = {k: v[sel] for k, v in tab.items()}
    want = zero_grads(tab_r, temps[sel])
    for plan, classes, stride in band.parts:
        gt = tile_cotangent(g[sel], plan)
        for dc, gidx in classes:
            gc = gt if gidx is None else gt[:, torch.as_tensor(
                gidx, device=gt.device).long()]
            plain_shell_vjp(plan, dc, tab_r, temps[sel], gc,
                            stride=1 if full_res else stride, gidx=gidx,
                            grads=want, **kw)
    got = {k: v[sel] for k, v in acc_grads(acc, torch.float64).items()}
    return _grad_rel(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("nrows", [1, 7])
@pytest.mark.parametrize("wfn", ["r2", "asym2"])
@pytest.mark.parametrize("stride", [2, 8])
def test_shell_backward_matches_plain(card, stride, wfn, nrows):
    """One shell backward launch (the fine grid's band-0 shells at tw
    512, Voigt function ``wfn``, ``stride``) on ``nrows`` rows against the
    plain VJPs."""
    import dataclasses
    from transit_tpu_torch.opacities.kernel_shell import shell_band
    parts, tab, temps, kw = _band_state(_fine_model(card))
    band = shell_band([(dataclasses.replace(p, wfn_tag=wfn), c, stride)
                       for p, c, _ in parts[:2]])
    rows = torch.arange(3, 3 + nrows, dtype=torch.int32, device=card)
    assert _shell_bwd_vs_plain(band, tab, temps, kw, rows) < 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["empty_and_long", "full_res",
                                  "ethresh_cuts_all"])
def test_shell_backward_edge_cases(card, case):
    """Empty tiles and tiles longer than a staged chunk; full resolution
    (stride 1, no clip mask); ethresh above 1 (every line cut: no
    cotangent at all)."""
    from transit_tpu_torch.opacities.kernel_shell import shell_band
    parts, tab, temps, kw = _band_state(_fine_model(card))
    (p0, c0, s0), (p1, c1, s1) = parts[:2]
    if case == "empty_and_long":
        band = shell_band([
            (p0, _dense_class(p0, c0, [0], 100, [2, 5]), s0),
            (p1, _dense_class(p1, c1, [0, 3], 100, [5]), s1)])
    else:
        band = shell_band(parts)
    if case == "ethresh_cuts_all":
        kw = {**kw, "ethresh": 2.0}
    rows = torch.arange(7, dtype=torch.int32, device=card)
    assert _shell_bwd_vs_plain(band, tab, temps, kw, rows,
                               full_res=case == "full_res") < 1e-4


def _kmax_inputs(card, nl, profile):
    """The fixture's line list repeated to 51,136 lines with gf scaled by
    seeded random factors, and nl layers of coefficients (the fixture's
    20 layers cycled) at the temperatures ``profile``: isothermal 300 K
    or 3000 K, or the fixture's profile cycled with seeded offsets."""
    m = _model(card)
    args, _ = _state(m)
    rng = np.random.default_rng(nl)
    d = {k: m.fdev[k].repeat(272) for k in
         ("all_wavn", "all_elow", "all_gf", "all_iso")}
    d["all_gf"] = d["all_gf"] * torch.as_tensor(
        rng.uniform(0.5, 2.0, d["all_gf"].shape[0]), dtype=torch.float32,
        device=card)
    coef0 = strength_coef(m.fdev, args[2])
    layer = torch.arange(nl, device=card) % coef0.shape[0]
    if profile == "profile":
        T = args[0][layer] + torch.as_tensor(
            rng.uniform(-100.0, 100.0, nl), dtype=torch.float32,
            device=card)
    else:
        T = torch.full((nl,), float(profile[:-1]), device=card)
    return d, T, coef0[layer].contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("floor", [-float("inf"), 0.0])
@pytest.mark.parametrize("profile", ["300K", "3000K", "profile"])
@pytest.mark.parametrize("nl", [1, 7, 100, 101])
def test_layer_kmax_bitwise_layers_and_profiles(card, nl, profile, floor):
    """layer_kmax equals plain_kmax bit for bit at 1, 7, 100 and 101
    layers (ragged layer blocks of the kernel), isothermal and not, with
    both floors."""
    d, T, coef0 = _kmax_inputs(card, nl, profile)
    got = layer_kmax(d, T, coef0, floor=floor)
    want = plain_kmax(d, T, coef0, floor=floor)
    torch.cuda.synchronize()
    assert torch.isfinite(want).all() and torch.equal(got, want)


def _transit_hj(card):
    """chip_smoke.py's transit path cut in wavenumber: the hot-Jupiter
    files at 3000-3020 cm-1 (41 wavenumbers, 100 layers), bands=6,
    transit geometry (toomuch 20) with hydrostatic radii (gsurf 2479 cm
    s-2 at the file's 1-bar layer, 73760 km)."""
    hj = os.path.join(os.path.dirname(FIX), "..", "benchmarks", "data", "hj")
    cfg = TransitConfig(
        atm=f"{hj}/hj.atm", linedb=f"{hj}/hj.tli",
        csfile=f"{hj}/cia_H2_H2.dat,{hj}/cia_H2_He.dat",
        molfile=f"{hj}/molecules.dat", wnlow=3000.0, wnhigh=3020.0,
        wndelt=0.5, wnosamp=2, wnfct=1.0, nwidth=20.0, ethreshold=1e-8,
        solution="transit", toomuch=20.0, gsurf=2479.0, refpress=1.0,
        refradius=73760.0)
    return TransitModel(cfg, mode="fast",
                        dtype=torch.float32, device=card, bands=6)


@pytest.mark.cuda
def test_transit_path_launches_match_plain(card):
    """The transit path with hydrostatic radii launches the line-tile
    kernels and layer_kmax in its forward and line_tile_backward in its
    gradient; spectrum (<= 1e-4) and gradient (< 1e-3 of max) against
    its plain path."""
    from transit_tpu_torch.opacities.kernel_lbl import line_tile_backward
    m = _transit_hj(card)
    assert m.hydrostatic and m.solution == "transit"

    def step():
        T, q = (torch.tensor(np.asarray(a, dtype=np.float64),
                             dtype=torch.float32, device=card,
                             requires_grad=True)
                for a in (m.atm.temp + 25.0, m.atm.q))
        s = m.forward(T, q)
        return s.detach(), torch.autograd.grad(s.sum(), (T, q))

    before = (line_tile_extinction.launches, layer_kmax.launches,
              line_tile_backward.launches)
    s, g = step()
    torch.cuda.synchronize()
    after = (line_tile_extinction.launches, layer_kmax.launches,
             line_tile_backward.launches)
    assert after[0] > before[0] and after[1] == before[1] + 1
    assert after[2] - before[2] == len(m.bplan.plans)
    m.use_kernel = False
    sp, gp = step()
    assert bool(torch.isfinite(s).all()) and float(s.min()) > 0
    assert float(((s - sp).abs() / sp.abs()).max()) <= 1e-4
    for a, b in zip(g, gp):
        assert float((a - b).abs().max() / b.abs().max()) < 1e-3


@pytest.mark.cuda
def test_forward_batch_hydrostatic_on_card(card):
    """forward_batch (B = 2) on the transit path with hydrostatic radii:
    every member's radii, path weights and modulation table; spectra and
    gradient as the loop's, one line_tile_backward launch per band."""
    m = _transit_hj(card)
    (fwd_lines, _), (lines, shells) = _batch_vs_loop(m, card, 17)
    assert fwd_lines > 0 and (lines, shells) == (len(m.bplan.plans), 0)


@pytest.mark.cuda
def test_hmc_steps_on_card(card):
    """A few HMC steps through forward_batch on the transit path: 4
    chains of a 4-knot log-temperature profile, a seeded generator on the
    card; finite samples and log posteriors, some proposal accepted."""
    from transit_tpu_torch.retrieval import (batched_value_and_grad,
                                             gaussian_logprob, hmc_sample,
                                             knot_profile)
    m = _transit_hj(card)
    nl = m.atm.nlayers
    q = m._t(m.atm.q)

    def fwd(z):
        return m.forward_batch(knot_profile(torch.exp(z), nl),
                               q.expand((z.shape[0],) + q.shape))

    z0 = torch.full((4,), float(np.log(np.mean(m.atm.temp))), device=card)
    with torch.no_grad():
        obs = fwd(z0[None])[0]
    lp = gaussian_logprob(fwd, obs, 1e-2 * float(obs.abs().mean()),
                          prior_mean=float(z0[0]), prior_sigma=0.5)
    gen = torch.Generator(device=card).manual_seed(5)
    x0 = z0[None] + 0.01 * torch.randn((4, 4), generator=gen, device=card)
    samples, accept, (xf, lpf) = hmc_sample(
        None, x0, gen, step_size=1e-4, n_leapfrog=2, n_samples=2,
        vg_fn=batched_value_and_grad(lp))
    assert samples.shape == (2, 4, 4) and samples.device.type == "cuda"
    assert bool(torch.isfinite(samples).all())
    assert bool(torch.isfinite(lpf).all()) and bool(accept.any())


def _exact_pair(card):
    """The fixture's exact model in float32 on the card and in float64 on
    the CPU, sharing the CPU's profile table (the card would build the
    same one: chip_smoke.py checks that)."""
    m64 = _model("cpu", torch.float64, mode="exact")
    return _model(card, mode="exact", table=m64.table), m64


@pytest.mark.cuda
def test_profile_scatter_kernels_match_plain(card):
    """profile_scatter and profile_scatter_backward on the fixture's
    exact model at three temperature profiles: the forward against the
    plain scatter (max|a-b| / (|a| + 1e-6 max|a|) < 1e-5), its pair
    counter equal to lbl.scatter_pairs, the backward against the plain
    VJP bit for bit."""
    from transit_tpu_torch.opacities import lbl
    from transit_tpu_torch.opacities.kernel_profile import (
        profile_scatter, profile_scatter_backward)
    m, _ = _exact_pair(card)
    s = lbl.scatter_tables(m.plan, m.dev)
    for dT in (0.0, 150.0, -150.0):
        t = m._t(m.atm.temp + dT)
        grp = lbl.layer_groups(m.dev, t * m.atm.tfct, m._t(m.atm.d),
                               m.partition(t), m._molm_t, m._molrad_t,
                               float(m.wns.v[0]), m.cfg.ethreshold)
        args = (grp["g_k"], grp["g_idop"], grp["ilor"], s)
        stats = torch.zeros(1, dtype=torch.int64, device=card)
        got = profile_scatter(*args, stats=stats)
        want = lbl.profile_scatter_plain(*args)
        torch.cuda.synchronize()
        assert float(want.max()) > 0
        assert _rel(want, got) < 1e-5
        assert int(stats[0]) == lbl.scatter_pairs(*args) > 0
        ct = torch.as_tensor(np.random.default_rng(3).standard_normal(
            tuple(got.shape)), dtype=torch.float32, device=card)
        a = profile_scatter_backward(ct, grp["keep"], *args[1:])
        b = lbl.profile_scatter_plain_vjp(ct, grp["keep"], *args[1:])
        assert torch.equal(a, b)
        assert bool((a[~grp["keep"]] == 0).all())


def _scatter_vs_plain(g_k, keep, g_idop, ilor, s):
    """One launch of each profile-scatter kernel against its plain
    version: the forward within 1e-5 (max|a-b| / (|a| + 1e-6 max|a|)),
    its pair counter equal to lbl.scatter_pairs, the backward bit for
    bit and 0 where no group is kept."""
    from transit_tpu_torch.opacities import lbl
    from transit_tpu_torch.opacities.kernel_profile import (
        profile_scatter, profile_scatter_backward)
    args = (g_k, g_idop, ilor, s)
    stats = torch.zeros(1, dtype=torch.int64, device=g_k.device)
    got = profile_scatter(*args, stats=stats)
    want = lbl.profile_scatter_plain(*args)
    torch.cuda.synchronize()
    assert float(want.max()) > 0 and _rel(want, got) < 1e-5
    assert int(stats[0]) == lbl.scatter_pairs(*args) > 0
    ct = torch.as_tensor(np.random.default_rng(4).standard_normal(
        tuple(got.shape)), dtype=torch.float32, device=g_k.device)
    a = profile_scatter_backward(ct, keep, *args[1:])
    b = lbl.profile_scatter_plain_vjp(ct, keep, *args[1:])
    assert torch.equal(a, b) and bool((a[~keep] == 0).all())
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["runs", "across_runs", "one_layer"])
def test_profile_scatter_synthetic(card, case):
    """The kernels on chip_smoke.synthetic_scatter: tiles wider than the
    shared segment (the global-memory path) and inside it, windows
    clipped at bins 0 and n_coarse - 1, a layer with no kept group, 700
    groups (not a multiple of the tile); with a tile table that crosses
    an isotope run ("across_runs"), and with one layer."""
    from chip_smoke import SYN_SHAPE, synthetic_scatter
    from transit_tpu_torch.opacities import lbl
    ng = SYN_SHAPE[1]
    kw = {"one_layer": {"nl": 1}, "across_runs": {"tiles": np.append(
        np.arange(0, ng, lbl.SCATTER_TILE), ng)}}.get(case, {})
    g_k, keep, g_idop, ilor, s = synthetic_scatter(card, **kw)
    spans = lbl.tile_spans(keep, g_idop, ilor, s)
    assert bool((spans > lbl.SCATTER_SEGMENT).any())
    # Across runs every tile is wider than the segment.
    assert bool(((spans > 0) & (spans <= lbl.SCATTER_SEGMENT)).any()) == (
        case != "across_runs")
    out = _scatter_vs_plain(g_k, keep, g_idop, ilor, s)
    if case != "one_layer":
        assert not bool(out[1].any())


@pytest.mark.cuda
@pytest.mark.parametrize("tiling", ["runs", "across_runs", "one_group", "37"])
def test_profile_scatter_tile_tables(card, tiling):
    """The fixture's exact groups under other tile tables: lbl's (cut at
    the isotope runs), one cut every SCATTER_TILE groups across the runs,
    one group a tile and 37 groups a tile (tiles of partly idle
    threads)."""
    from transit_tpu_torch.opacities import lbl
    m, _ = _exact_pair(card)
    t = m._t(m.atm.temp)
    grp = lbl.layer_groups(m.dev, t * m.atm.tfct, m._t(m.atm.d),
                           m.partition(t), m._molm_t, m._molrad_t,
                           float(m.wns.v[0]), m.cfg.ethreshold)
    s = lbl.scatter_tables(m.plan, m.dev)
    ng = m.plan.n_groups
    step = {"across_runs": lbl.SCATTER_TILE, "one_group": 1, "37": 37}
    if tiling in step:
        s = dataclasses.replace(s, tiles=torch.as_tensor(np.append(
            np.arange(0, ng, step[tiling]), ng).astype(np.int32),
            device=card))
    _scatter_vs_plain(grp["g_k"], grp["keep"], grp["g_idop"], grp["ilor"],
                      s)


@pytest.mark.cuda
def test_profile_scatter_refuses_a_malformed_tile_table(card):
    """A tile longer than SCATTER_TILE (the kernels would drop its last
    groups) is refused before either kernel launches."""
    from chip_smoke import synthetic_scatter
    from transit_tpu_torch.opacities import kernel_profile
    g_k, keep, g_idop, ilor, s = synthetic_scatter(card, tiles=[0, 300,
                                                                700])
    n0 = (kernel_profile.profile_scatter.launches,
          kernel_profile.profile_scatter_backward.launches)
    with pytest.raises(ValueError, match="1 to 256"):
        kernel_profile.profile_scatter(g_k, g_idop, ilor, s)
    ct = torch.zeros((g_k.shape[0], s.n_coarse), device=card)
    with pytest.raises(ValueError, match="1 to 256"):
        kernel_profile.profile_scatter_backward(ct, keep, g_idop, ilor, s)
    assert n0 == (kernel_profile.profile_scatter.launches,
                  kernel_profile.profile_scatter_backward.launches)


@pytest.mark.cuda
def test_exact_spectrum_card_vs_cpu_float64(card):
    """The exact float32 spectrum on the card (the profile-scatter
    kernels) against the float64 port on the CPU: max |a/b - 1| < 1e-5
    (tests/test_torch_exact_model.py's float32 bound); the kernels ran,
    and the gradient's backward launched."""
    from transit_tpu_torch.opacities.kernel_profile import (
        profile_scatter, profile_scatter_backward)
    m, m64 = _exact_pair(card)
    n0, b0 = profile_scatter.launches, profile_scatter_backward.launches
    T = torch.tensor(m.atm.temp, dtype=torch.float32, device=card,
                     requires_grad=True)
    spec = m.forward(T, m._t(m.atm.q))
    g, = torch.autograd.grad(spec.sum(), T)
    torch.cuda.synchronize()
    assert profile_scatter.launches == n0 + 1
    assert profile_scatter_backward.launches == b0 + 1
    want = m64.forward(m64.atm.temp, m64.atm.q)
    rel = (spec.detach().double().cpu() / want - 1.0).abs().max()
    assert float(rel) < 1e-5 and bool(torch.isfinite(g).all())


@pytest.mark.cuda
def test_exact_vmap_forward_on_card(card):
    """torch.func.vmap(m.forward) of the exact model on the card equals a
    loop of forward (the kernels' vmap rule folds the batch into layers;
    float32 sums in another order: 1e-5 of max)."""
    m, _ = _exact_pair(card)
    T = m._t(np.stack([m.atm.temp, m.atm.temp + 40.0]))
    q = m._t(np.stack([m.atm.q, m.atm.q]))
    got = torch.func.vmap(m.forward)(T, q)
    for i in range(2):
        want = m.forward(T[i], q[i])
        assert float((got[i] - want).abs().max()) <= 1e-5 * float(
            want.abs().max())


@pytest.mark.cuda
def test_forward_batch_split_on_card(card, monkeypatch):
    """forward_batch on the card with model.INDEX_LIMIT lowered so that 3
    profiles run as three sub-batches: spectra and gradient as one pass's
    (float32: 1e-5 and 1e-4 of max)."""
    from transit_tpu_torch import model as model_module
    m = _model(card, bands=6)
    T = np.stack([m.atm.temp + d for d in (0.0, 30.0, -30.0)])
    q = np.stack([m.atm.q] * 3)

    def run():
        Tt, qt = (torch.tensor(a, dtype=torch.float32, device=card,
                               requires_grad=True) for a in (T, q))
        spec = m.forward_batch(Tt, qt)
        return (spec.detach(), *torch.autograd.grad(spec.sum(), (Tt, qt)))

    one = run()
    monkeypatch.setattr(model_module, "INDEX_LIMIT",
                        2 * m.atm.nlayers * m.wns.n)
    assert len(m.batch_splits(3)) == 3
    for (a, b), tol in zip(zip(run(), one), (1e-5, 1e-4, 1e-4)):
        assert float((a - b).abs().max()) <= tol * float(b.abs().max())


def _permol(s, mol_of_iso, nm):
    """``s`` with per-molecule rows: each group's molecule that of its
    isotope (mol_of_iso), through lbl.permol_tables."""
    from transit_tpu_torch.opacities import lbl
    g_iso = s.g_iso.long()
    iout = torch.as_tensor(np.asarray(mol_of_iso), device=g_iso.device)
    return lbl.permol_tables(s, iout[g_iso],
                             torch.arange(g_iso.shape[0],
                                          device=g_iso.device), nm)


@pytest.mark.cuda
@pytest.mark.parametrize("nl", [1, 8])
def test_profile_scatter_per_molecule_matches_plain(card, nl):
    """The per-molecule launch (the opacity-grid build) on
    chip_smoke.synthetic_scatter with its three isotope runs on three
    molecules (run i on molecule 2 - i): each tile adds to its molecule's
    row, (nl, 3, n_coarse), against the plain per-molecule scatter
    within 1e-5 (max|a-b| / (|a| + 1e-6 max|a|)); the pair counter
    equal to lbl.scatter_pairs; the molecules' rows sum to the
    collapsed launch's output (float32 atomics: within 1e-5)."""
    from chip_smoke import synthetic_scatter
    from transit_tpu_torch.opacities import lbl
    from transit_tpu_torch.opacities.kernel_profile import profile_scatter
    g_k, keep, g_idop, ilor, s = synthetic_scatter(card, nl=nl)
    s3 = _permol(s, [2, 1, 0], 3)
    args = (g_k, g_idop, ilor)
    stats = torch.zeros(1, dtype=torch.int64, device=card)
    n0 = profile_scatter.launches
    got = profile_scatter(*args, s3, stats=stats)
    want = lbl.profile_scatter_plain(*args, s3)
    one = profile_scatter(*args, s)
    torch.cuda.synchronize()
    assert profile_scatter.launches == n0 + 2
    assert got.shape == want.shape == (nl, 3, s.n_coarse)
    for m in range(3):
        assert float(want[:, m].max()) > 0
        assert _rel(want[:, m], got[:, m]) < 1e-5
    assert int(stats[0]) == lbl.scatter_pairs(*args, s) > 0
    assert _rel(one, got.sum(dim=1)) < 1e-5


@pytest.mark.cuda
def test_profile_scatter_one_molecule_is_the_collapsed_launch(card):
    """With nm = 1 the per-molecule launch computes what the collapsed
    one computes, bit for bit, on a case whose windows never overlap
    (every bin gets at most one product, so the float32 atomics add in
    one order): 4 layers, 600 groups in 3 isotope runs, windows of at
    most 3 bins, 12 bins apart."""
    from transit_tpu_torch.opacities import lbl
    from transit_tpu_torch.opacities.kernel_profile import profile_scatter
    rng = np.random.default_rng(11)
    nl, ng, of = 4, 600, 4
    n_coarse = 12 * ng + 8
    psize = np.array([[2, 3], [4, 5]], dtype=np.int32)
    sizes = 2 * psize.ravel() + 1
    base = np.concatenate([[0], np.cumsum(sizes)[:-1]]).reshape(psize.shape)
    g_iso = np.repeat(np.arange(3), [200, 250, 150]).astype(np.int32)
    idwn = 4 + 12 * np.arange(ng)
    iown = idwn * of + rng.integers(0, of + 1, ng)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=card)

    s = lbl.ScatterTables(
        g_iso=t(g_iso), g_iown=t(iown.astype(np.int32)),
        g_idwn=t(idwn.astype(np.int32)), profsize=t(psize),
        profbase=t(base.astype(np.int32)),
        profflat=t(rng.random(int(sizes.sum())).astype(np.float32)),
        ofactor=of, n_coarse=n_coarse,
        tiles=t(lbl.scatter_tiles(g_iso)))
    g_k = t(((0.1 + rng.random((nl, ng))) *
             (rng.random((nl, ng)) > 0.2)).astype(np.float32))
    g_idop = t(rng.integers(0, 2, (nl, ng)).astype(np.int32))
    ilor = t(rng.integers(0, 2, (nl, 3)).astype(np.int32))
    spans = lbl.scatter_geometry(g_idop, ilor, s)
    assert int((spans[4] - spans[3] + 1).max()) <= 3
    one = profile_scatter(g_k, g_idop, ilor, s)
    s1 = _permol(s, [0, 0, 0], 1)
    got = profile_scatter(g_k, g_idop, ilor, s1)
    torch.cuda.synchronize()
    assert got.shape == (nl, 1, n_coarse) and float(one.max()) > 0
    assert torch.equal(got[:, 0], one)
    assert torch.equal(one, lbl.profile_scatter_plain(g_k, g_idop, ilor, s))


@pytest.mark.cuda
@pytest.mark.parametrize("bands", [0, 6])
def test_sharded_step_on_card(card, bands):
    """The fixture in 4 shards on the card: each shard's launches are the
    model's on its tiles (the line-tile kernel once per class of each
    shard, layer_kmax once a shard, also on the unbanded plan's one-class
    shards), and the assembled spectrum and gradient equal the unsharded
    ones (<= 1e-5, < 1e-3 of the max, chip_smoke.py's gates)."""
    from transit_tpu_torch.opacities import banded
    from transit_tpu_torch.parallel.sharded import make_sharded_forward
    m = _model(card, bands=bands)
    step = make_sharded_forward(m, nshard=4)
    T0, q0 = np.asarray(m.atm.temp), np.asarray(m.atm.q)
    want = {"line_tile_extinction": 0, "layer_kmax": 4}
    for s in range(4):
        plan, d, index = step._view(s)
        want["line_tile_extinction"] += (
            sum(1 for _, part, _ in banded.launch_units(plan, d, index)
                if part != "shell") if bands else len(plan.class_tiles))
    line_tile_extinction.launches = layer_kmax.launches = 0
    spec = step.assemble([step.local(s, T0, q0) for s in range(4)])
    torch.cuda.synchronize()
    assert {"line_tile_extinction": line_tile_extinction.launches,
            "layer_kmax": layer_kmax.launches} == want
    ref = m.forward(T0, q0)
    assert float(((spec - ref).abs() / ref.abs()).max()) <= 1e-5

    def grad(f):
        T = torch.tensor(T0, dtype=torch.float32, device=card,
                         requires_grad=True)
        q = torch.tensor(q0, dtype=torch.float32, device=card,
                         requires_grad=True)
        return torch.autograd.grad(f(T, q).sum(), (T, q))
    for a, b in zip(grad(lambda T, q: step.assemble(
            [step.local(s, T, q) for s in range(4)])), grad(m.forward)):
        assert float((a - b).abs().max() / b.abs().max()) < 1e-3


def _graph_case(card, case):
    """The models of the graphed-step tests: the fixture's main path
    (bands=6) and its batch (B = 2), the unbanded plan and exact mode,
    and _transit_hj's transit path with hydrostatic radii."""
    if case == "transit":
        return _transit_hj(card)
    if case == "exact":
        return _exact_pair(card)[0]
    return _model(card, bands=0 if case == "unbanded" else 6)


def _requests(m, card, batch: int = 0):
    """Three (T, q) of the model on the card, T moved by 0, +40 and -30 K
    (each a batch of ``batch`` profiles when > 0)."""
    T0 = torch.tensor(np.asarray(m.atm.temp, dtype=np.float64),
                      dtype=torch.float32, device=card)
    q0 = torch.tensor(np.asarray(m.atm.q, dtype=np.float64),
                      dtype=torch.float32, device=card)
    out = []
    for dT in (0.0, 40.0, -30.0):
        T, q = T0 + dT, q0
        if batch:
            T = torch.stack([T + 7.0 * i for i in range(batch)])
            q = q.expand((batch,) + q.shape).contiguous()
        out.append((T, q))
    return out


def _grad(f, T, q):
    T = T.clone().requires_grad_(True)
    q = q.clone().requires_grad_(True)
    s = f(T, q)
    return (s.detach(),) + torch.autograd.grad(s.sum(), (T, q))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["main", "batch", "unbanded", "transit",
                                  "exact"])
def test_make_forward_graph_matches_eager(card, case):
    """make_forward on the card replays CUDA graphs (no kernel launch is
    counted by a replay) whose spectra equal the eager forward's bit for
    bit (exact mode: within 1e-6 of the max, its co-add sums use float
    atomics), and whose gradients equal the eager ones within 1e-6 of
    the max (the backward kernels add in float64 atomics); the result
    of a call is unchanged by the next call."""
    m = _graph_case(card, case)
    fwd = m.make_forward()
    eager = m.forward_batch if case == "batch" else m.forward
    reqs = _requests(m, card, batch=2 if case == "batch" else 0)
    with torch.no_grad():
        fwd(*reqs[0])                                   # capture
        line_tile_extinction.launches = 0
        got = [fwd(T, q) for T, q in reqs]
        assert line_tile_extinction.launches == 0
        first = got[0].clone()
        want = [eager(T, q) for T, q in reqs]
    for a, b in zip(got, want):
        assert a.shape == b.shape and bool(torch.isfinite(a).all())
        if case == "exact":
            assert float((a - b).abs().max() / b.abs().max()) <= 1e-6
        else:
            assert torch.equal(a, b)
    assert torch.equal(got[0], first) and not torch.equal(got[0], got[1])
    held = None
    for T, q in reqs:
        a, b = _grad(fwd, T, q), _grad(eager, T, q)
        held = held or tuple(x.clone() for x in a) + a
        for x, y in zip(a, b):
            assert float((x - y).abs().max() / y.abs().max()) <= 1e-6
    # The first request's spectrum and gradients, held, are its own:
    for x, y in zip(held[3:], held[:3]):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_make_forward_fixes_settings_on_card(card):
    """A callable made before set_cloudtop keeps the old deck; one made
    after it equals the eager forward with the new one."""
    m = _model(card, bands=6)
    m.cfg.cloudtop = -1.0
    m._cloud = m._parse_cloud()
    T, q = _requests(m, card)[1]
    with torch.no_grad():
        old, before = m.make_forward(), m.forward(T, q)
        old(T, q)
        m.set_cloudtop(-3.0)
        after = m.forward(T, q)
        assert not torch.equal(before, after)
        assert torch.equal(old(T, q), before)
        assert torch.equal(m.make_forward()(T, q), after)


@pytest.mark.cuda
def test_make_forward_refuses_a_late_gradient(card):
    """A call's gradient taken after the next call of its signature
    replayed the forward raises: the graph holds one set of activations."""
    m = _model(card, bands=6)
    fwd = m.make_forward()
    (T1, q), (T2, _) = _requests(m, card)[:2]
    T1, T2 = T1.requires_grad_(True), T2.requires_grad_(True)
    s1 = fwd(T1, q)
    torch.autograd.grad(s1.sum(), T1)        # captured, then replayed
    s1 = fwd(T1, q)
    fwd(T2, q)
    with pytest.raises(RuntimeError, match="later call"):
        torch.autograd.grad(s1.sum(), T1)


@pytest.mark.cuda
def test_make_forward_capture_failure_raises(card, monkeypatch):
    """A host read in the step (here tau.last read back with .item())
    makes the capture fail: the call raises, naming the line, and never
    falls back to the eager step; the model still runs eagerly."""
    from transit_tpu_torch.rt import tau as rt_tau
    m = _model(card, bands=6)
    T, q = _requests(m, card)[0]
    last_index = rt_tau.last_index

    def host_read(tau, toomuch):
        if float(tau.max()) < 0:
            raise AssertionError
        return last_index(tau, toomuch)
    monkeypatch.setattr(rt_tau, "last_index", host_read)
    fwd = m.make_forward()
    for grad in (False, True):
        with torch.set_grad_enabled(grad), pytest.raises(
                RuntimeError, match="make_forward: capturing the step"):
            fwd(T, q.clone().requires_grad_(grad))
        torch.cuda.synchronize()
    assert not fwd.entries
    monkeypatch.setattr(rt_tau, "last_index", last_index)
    with torch.no_grad():
        assert bool(torch.isfinite(m.forward(T, q)).all())
        assert torch.equal(m.make_forward()(T, q), m.forward(T, q))


def _grid_model(device):
    """The fixture in grid mode: the conformance grid file
    (tests/golden/ref_opacity_grid.bin, 1000-2000 K)."""
    return TransitModel(_config(
        opacityfile=os.path.join(os.path.dirname(FIX), "golden",
                                 "ref_opacity_grid.bin"),
        tlow=1000.0, thigh=2000.0, tempdelt=100.0), dtype=torch.float32,
        device=device)


def _band_kmax(m, T):
    """The model's own per-layer kmax at T, an external kmax."""
    from transit_tpu_torch.opacities.banded import line_kmax
    d0 = m.bdev[0] if m.bdev is not None else m.fdev
    return line_kmax(d0, T * m.atm.tfct, m.partition(T))


def _close(a, b, tol=1e-6):
    return torch.equal(a, b) or float(
        (a - b).abs().max() / b.abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("case,nshard,kmax", [
    ("main", 1, False), ("main", 4, False), ("main", 4, True),
    ("unbanded", 4, False), ("unbanded", 4, True), ("grid", 1, False),
    ("grid", 4, False)])
def test_sharded_graph_matches_eager(card, case, nshard, kmax):
    """make_sharded_forward on the card is the compiled step (one CUDA
    graph of every shard's local and the assembly; no launch is counted
    by a replay): its spectra equal the eager ShardedStep's bit for bit,
    its gradients within 1e-6 of the max (the backward kernels add in
    float64 atomics), with an external kmax as the third argument; the
    result of a call is unchanged by the next call."""
    from transit_tpu_torch.parallel.sharded import (GraphedShardedStep,
                                                    ShardedStep,
                                                    make_sharded_forward)
    m = _grid_model(card) if case == "grid" else _model(
        card, bands=0 if case == "unbanded" else 6)
    step = make_sharded_forward(m, nshard=nshard, external_kmax=kmax)
    eager = ShardedStep(m, nshard=nshard, external_kmax=kmax)
    assert isinstance(step, GraphedShardedStep)
    reqs = [(T, q) + ((_band_kmax(m, T),) if kmax else ())
            for T, q in _requests(m, card)]
    with torch.no_grad():
        step(*reqs[0])                                  # capture
        line_tile_extinction.launches = 0
        got = [step(*r) for r in reqs]
        assert line_tile_extinction.launches == 0
        first = got[0].clone()
        want = [eager(*r) for r in reqs]
    for a, b in zip(got, want):
        assert a.shape == (m.wns.n,) and torch.equal(a, b)
    assert torch.equal(got[0], first) and not torch.equal(got[0], got[1])
    held = None
    for T, q, *k in reqs:
        a = _grad(lambda T, q: step(T, q, *k), T, q)
        b = _grad(lambda T, q: eager(T, q, *k), T, q)
        held = held or tuple(x.clone() for x in a) + a
        assert float(a[1].abs().max()) > 0
        assert all(_close(x, y) for x, y in zip(a, b))
    for x, y in zip(held[3:], held[:3]):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_sharded_graph_with_group(card, tmp_path):
    """The compiled step over a world-size-1 NCCL group: the rank's local
    replayed from CUDA graphs, the all-gather and the gradient's
    all-reduce around it; bit for bit the eager local assembly, forward
    and gradient."""
    import datetime

    import torch.distributed as dist
    from transit_tpu_torch.parallel.sharded import make_sharded_forward
    m = _model(card, bands=6)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=120))
    try:
        step = make_sharded_forward(m, group=dist.group.WORLD)

        def local(T, q):
            return step.assemble([step.local(0, T, q)])
        for T, q in _requests(m, card)[:2]:
            with torch.no_grad():
                assert torch.equal(step(T, q), local(T, q))
            for _ in range(2):                      # capture, replay
                a, b = _grad(step, T, q), _grad(local, T, q)
                assert all(torch.equal(x, y) for x, y in zip(a, b))
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_sharded_graph_refuses_a_late_gradient(card):
    from transit_tpu_torch.parallel.sharded import make_sharded_forward
    m = _model(card, bands=6)
    step = make_sharded_forward(m, nshard=2)
    (T1, q), (T2, _) = _requests(m, card)[:2]
    T1, T2 = T1.requires_grad_(True), T2.requires_grad_(True)
    s1 = step(T1, q)
    torch.autograd.grad(s1.sum(), T1)        # captured, then replayed
    s1 = step(T1, q)
    step(T2, q)
    with pytest.raises(RuntimeError, match="later call"):
        torch.autograd.grad(s1.sum(), T1)


@pytest.mark.cuda
def test_sharded_graph_capture_failure_raises(card, monkeypatch):
    """A host read in a shard's step makes the capture fail: the call
    raises, naming the line, and never falls back to the eager step."""
    from transit_tpu_torch.parallel.sharded import make_sharded_forward
    from transit_tpu_torch.rt import tau as rt_tau
    m = _model(card, bands=6)
    T, q = _requests(m, card)[0]
    last_index = rt_tau.last_index

    def host_read(tau, toomuch):
        if float(tau.max()) < 0:
            raise AssertionError
        return last_index(tau, toomuch)
    monkeypatch.setattr(rt_tau, "last_index", host_read)
    step = make_sharded_forward(m, nshard=2)
    for grad in (False, True):
        with torch.set_grad_enabled(grad), pytest.raises(
                RuntimeError, match=r"make_sharded_forward: capturing the "
                r"step .* failed at transit_tpu_torch/"):
            step(T, q.clone().requires_grad_(grad))
        torch.cuda.synchronize()
    assert not step._graph.entries
    monkeypatch.setattr(rt_tau, "last_index", last_index)
    with torch.no_grad():
        assert torch.equal(make_sharded_forward(m, nshard=2)(T, q),
                           step.assemble([step.local(s, T, q)
                                          for s in range(2)]))


@pytest.mark.cuda
def test_multihost_one_process_graph_matches_eager(card):
    """MultihostForward with one process on the card: the band step and
    the band kmax are CUDA graph replays; forward, local_spectrum and
    value_and_grad equal those of the same runner with the eager
    ShardedStep and kmax (the spectrum bit for bit, the gradient within
    1e-6 of the max)."""
    import copy

    from transit_tpu_torch.parallel import multihost
    from transit_tpu_torch.parallel.sharded import (GraphedShardedStep,
                                                    ShardedStep)
    run = multihost.MultihostForward(_config(), bands=6,
                                     dtype=torch.float32, device=card)
    assert isinstance(run._step, GraphedShardedStep) and run.exact_ethresh
    eager = copy.copy(run)
    eager._step = ShardedStep(run.model, external_kmax=True)
    eager._kmax_fn = run._band_kmax

    def loss(spec, block):
        return (spec * torch.linspace(0.5, 2.0, spec.shape[0],
                                      device=spec.device)).sum()
    for T, q in _requests(run.model, card):
        assert torch.equal(run.forward(T, q), eager.forward(T, q))
        assert torch.equal(run.local_spectrum(T, q),
                           eager.local_spectrum(T, q))
        va, ga = run.value_and_grad(loss, T, q)
        vb, gb = eager.value_and_grad(loss, T, q)
        assert _close(va, vb) and all(_close(x, y) for x, y in zip(ga, gb))
    assert run._kmax_fn.entries and run._step._graph.entries
