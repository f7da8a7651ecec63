"""The port's exact-mode model through its entry points, on the
conformance fixture (one profile table for the module): ``forward``
equals ``compute`` at the file's atmosphere (rtol 1e-12, as
tests/test_fast_and_forward.py:149-155 holds JAX), ``run_transit``
equals ``forward``, ``forward_batch`` raises with JAX's message,
``torch.func.vmap(m.forward)`` equals a loop of ``forward`` (values and
gradients), float32 against float64, the default mode is JAX's, and
a profile table of another configuration is refused.  Layers in chunks
(lbl.chunk_rows, forced small here through lbl.GROUP_ROW_ENTRIES):
chunks of 1 and of 7 layers give the one-chunk path's bits, float64 and
float32, in ``forward``, its gradient in T and q, ``torch.func.vmap(
m.forward)`` and its gradient, and the vmap of ``torch.func.grad`` (with
the Doppler fill's running max in segments, lbl.row_cummax, which
equals torch.cummax); the chunk rule keeps a hot-Jupiter model in one
chunk on the card and cuts a 2.0e7-line one.
The gradient against jax.grad: tests/test_torch_exact_grad*.py."""

import dataclasses
import inspect
import types

import numpy as np
import pytest
import torch

from tests.test_conformance import make_config
from transit_tpu.model import TransitModel as JModel
from transit_tpu_torch.config import TransitConfig
from transit_tpu_torch.model import TransitModel
from transit_tpu_torch.opacities import kernel_profile, lbl

torch.set_num_threads(1)

# float32 against float64 exact spectra: max |a/b - 1|, float32 rounding
# of the extinction sums and of tau's products (3.4e-7 on the eclipse
# fixture when this bound was set; 30x margin).
F32_TOL = 1e-5


def port(cfg):
    return TransitConfig(**dataclasses.asdict(cfg))


@pytest.fixture(scope="module")
def m64():
    return TransitModel(port(make_config("eclipse", 1e30)),
                        dtype=torch.float64, device="cpu")


def profiles(m, n=3, seed=5):
    """n (T, q) profiles near the file's, made with numpy from a seed."""
    rng = np.random.default_rng(seed)
    T0, q0 = m.atm.temp, m.atm.q
    T = np.stack([T0 * (1.0 + 0.02 * rng.uniform(-1, 1)) +
                  rng.normal(0.0, 3.0, T0.shape) for _ in range(n)])
    q = np.stack([q0 * (1.0 + 0.05 * rng.uniform(-1, 1, q0.shape))
                  for _ in range(n)])
    return T, q


def test_default_mode_is_jax_default(m64):
    port_default = inspect.signature(TransitModel).parameters["mode"]
    jax_default = inspect.signature(JModel).parameters["mode"]
    assert port_default.default == jax_default.default == "exact"
    assert m64.mode == "exact" and m64.plan is not None
    assert m64.device_tree() is m64.dev


def test_forward_matches_compute(m64):
    spec0 = m64.compute().spectrum.numpy()
    spec1 = m64.forward(m64.atm.temp, m64.atm.q).numpy()
    np.testing.assert_allclose(spec1, spec0, rtol=1e-12)


def test_run_transit_matches_forward(m64):
    T, q = profiles(m64, 1)
    flat = np.concatenate([T[0], q[0].ravel()])
    np.testing.assert_array_equal(m64.run_transit(flat).numpy(),
                                  m64.forward(T[0], q[0]).numpy())


def test_forward_batch_raises(m64):
    T, q = profiles(m64, 2)
    with pytest.raises(ValueError, match="mode='fast'"):
        m64.forward_batch(torch.as_tensor(T), torch.as_tensor(q))


def test_vmap_forward_equals_loop(m64):
    """torch.func.vmap(m.forward) over 3 profiles against 3 forward calls,
    and the gradient of its sum in T and q against theirs."""
    T, q = profiles(m64)
    Tb = torch.tensor(T, requires_grad=True)
    qb = torch.tensor(q, requires_grad=True)
    spec = torch.func.vmap(m64.forward)(Tb, qb)
    gT, gq = torch.autograd.grad(spec.sum(), (Tb, qb))
    for i in range(T.shape[0]):
        t = torch.tensor(T[i], requires_grad=True)
        qq = torch.tensor(q[i], requires_grad=True)
        s = m64.forward(t, qq)
        a, b = torch.autograd.grad(s.sum(), (t, qq))
        np.testing.assert_allclose(spec[i].detach().numpy(),
                                   s.detach().numpy(), rtol=1e-12)
        for x, y in ((gT[i], a), (gq[i], b)):
            assert float((x - y).abs().max()) <= 1e-10 * float(y.abs().max())


def test_float32_against_float64(m64):
    m32 = TransitModel(port(make_config("eclipse", 1e30)),
                       dtype=torch.float32, device="cpu", table=m64.table)
    a = m32.compute().spectrum.double().numpy()
    b = m64.compute().spectrum.numpy()
    assert a.dtype == b.dtype and a.shape == b.shape
    assert float(np.max(np.abs(a / b - 1.0))) < F32_TOL


@pytest.mark.parametrize("field, value", [("nwidth", 10.0), ("ndop", 14),
                                          ("dmin", 2e-3), ("wnosamp", 1)])
def test_table_of_another_configuration_raises(m64, field, value):
    cfg = port(make_config("eclipse", 1e30))
    setattr(cfg, field, value)
    with pytest.raises(ValueError, match="profile table"):
        TransitModel(cfg, dtype=torch.float64, device="cpu", table=m64.table)


@pytest.fixture(scope="module")
def m32(m64):
    return TransitModel(port(make_config("eclipse", 1e30)),
                        dtype=torch.float32, device="cpu", table=m64.table)


def chunk_outputs(m):
    """forward and its gradient in T and q at a profile; vmap(m.forward)
    over 3 profiles and the gradient of its sum; the vmap of
    torch.func.grad of the forward's sum, in the model's dtype."""
    T, q = profiles(m)
    dt = m.dtype
    t = torch.tensor(T[0], dtype=dt, requires_grad=True)
    qq = torch.tensor(q[0], dtype=dt, requires_grad=True)
    spec = m.forward(t, qq)
    out = [spec, *torch.autograd.grad(spec.sum(), (t, qq))]
    Tb = torch.tensor(T, dtype=dt, requires_grad=True)
    qb = torch.tensor(q, dtype=dt, requires_grad=True)
    specs = torch.func.vmap(m.forward)(Tb, qb)
    out += [specs, *torch.autograd.grad(specs.sum(), (Tb, qb))]
    out += torch.func.vmap(torch.func.grad(
        lambda a, b: m.forward(a, b).sum(), argnums=(0, 1)))(
            torch.tensor(T, dtype=dt), torch.tensor(q, dtype=dt))
    return [x.detach() for x in out]


_ONE_CHUNK = {}


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("rows", [1, 7])
def test_layer_chunks_equal_one_chunk(m64, m32, monkeypatch, dtype, rows):
    m = m64 if dtype == "float64" else m32
    nl = m.atm.nlayers
    assert lbl.chunk_rows(m.plan, "cpu", m.wns.n) >= nl
    if dtype not in _ONE_CHUNK:
        _ONE_CHUNK[dtype] = chunk_outputs(m)
    want = _ONE_CHUNK[dtype]
    monkeypatch.setitem(lbl.GROUP_ROW_ENTRIES, "cpu",
                        rows * max(m.plan.n_lines, m.plan.n_groups))
    assert lbl.chunk_rows(m.plan, "cpu", m.wns.n) == rows
    # The Doppler fill's running max in segments, the last one short.
    monkeypatch.setattr(lbl, "CUMMAX_SEGMENT", 100)
    assert m.plan.n_groups > 100 and m.plan.n_groups % 100 != 0
    assert nl % rows != 0 or rows == 1       # the last chunk is short
    calls = []
    groups = kernel_profile.layer_groups
    monkeypatch.setattr(kernel_profile, "layer_groups",
                        lambda *a, **k: calls.append(1) or groups(*a, **k))
    with torch.no_grad():
        m.forward(m.atm.temp, m.atm.q)
    assert len(calls) == -(-nl // rows)      # one layer_groups a chunk
    got = chunk_outputs(m)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == m.dtype and float(b.abs().max()) > 0
        assert torch.equal(a, b)


@pytest.mark.parametrize("rows", [None, 7])
def test_doppler_fill_function_equals_plain(m32, monkeypatch, rows):
    """kernel_profile.DopplerFill, the Doppler fill kernel's wrapper for
    torch.func, with a stand-in launch (lbl.doppler_fill_plain, handed
    plain tensors): forward, gradient, vmap(m.forward) and its gradient
    and the vmap of torch.func.grad, in one chunk and in chunks of 7
    (each chunk's recompute under torch.func.vjp), give the plain path's
    bits."""
    if "float32" not in _ONE_CHUNK:
        _ONE_CHUNK["float32"] = chunk_outputs(m32)
    want = _ONE_CHUNK["float32"]
    seen = []

    def launch(*args):
        assert not any(torch._C._functorch.is_functorch_wrapped_tensor(a)
                       for a in args)
        seen.append(args[0].shape[0])
        return lbl.doppler_fill_plain(*args)

    def fill(keep, alphad, alphal, idop0, d, use_kernel=True):
        return kernel_profile.DopplerFill.apply(
            keep, alphad, alphal, idop0, d["g_iso"], d["g_wavn"],
            d["g_iso_start"], d["aDop"])

    monkeypatch.setattr(kernel_profile, "doppler_fill", launch)
    monkeypatch.setattr(kernel_profile, "doppler_fill_fn", fill)
    if rows:
        monkeypatch.setitem(lbl.GROUP_ROW_ENTRIES, "cpu",
                            rows * max(m32.plan.n_lines, m32.plan.n_groups))
    got = chunk_outputs(m32)
    nl = m32.atm.nlayers
    # Batched calls fold the 3 profiles into the rows.
    assert 3 * nl in seen if rows is None else max(seen) == rows
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n, m, seg", [(3, 10, 4), (5, 4097, 4096),
                                       (2, 9, 3), (4, 1, 4)])
def test_row_cummax_is_cummax(monkeypatch, n, m, seg):
    rng = np.random.default_rng(n * m)
    x = torch.as_tensor(np.where(rng.uniform(size=(n, m)) < 0.3,
                                 rng.integers(0, 50, (n, m)), -1))
    monkeypatch.setattr(lbl, "CUMMAX_SEGMENT", seg)
    assert torch.equal(lbl.row_cummax(x), torch.cummax(x, dim=1).values)


@pytest.mark.parametrize("n_lines, chunks", [(194_349, 1),
                                             (20_017_947, 34)])
def test_chunk_rule(n_lines, chunks):
    """On the card a hot-Jupiter list (100 layers, 19001 wavenumbers) is
    one chunk; a 2.0e7-line list 34 chunks of 3 layers (the groups are
    fewer than the lines)."""
    plan = types.SimpleNamespace(n_lines=n_lines, n_groups=n_lines // 2)
    rows = lbl.chunk_rows(plan, "cuda", 19001)
    assert len(lbl.row_slices(100, rows)) == chunks
    assert rows * n_lines <= lbl.GROUP_ROW_ENTRIES["cuda"]
    assert lbl.chunk_rows(plan, "cuda", 2 ** 31) == 1
