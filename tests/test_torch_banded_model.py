"""The port's banded TransitModel against transit_tpu's on the eclipse
fixture with bands=6: the per-layer kmax against fast._kmax_scan,
split_far=False against the unbanded path, and forward against the JAX
banded model."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_conformance import make_config
from tests.test_torch_common import port_config, rel, state
from transit_tpu.model import TransitModel as JModel
from transit_tpu.opacities import fast as jfast
from transit_tpu_torch.model import TransitModel
from transit_tpu_torch.opacities import banded
from transit_tpu_torch.opacities.kernel_lbl import plain_extinction

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jax_banded():
    """The JAX banded model (f64)."""
    return JModel(make_config("eclipse", 1e30), mode="fast", bands=6), None


@pytest.fixture(scope="module")
def port64():
    return TransitModel(port_config(make_config("eclipse", 1e30)), mode="fast",
                        dtype=torch.float64, device="cpu", bands=6)


def test_kmax_matches_kmax_scan(jax_banded, port64):
    """prep_layers' kmax is fast._kmax_scan's: its carry starts at 0, so
    an empty line list gives 0, not jnp.max's -inf; ethresh above 1 then
    cuts every line."""
    jm, _ = jax_banded
    args, kw = state(jm, np.float64)
    prep = jfast._prep_layers(jm.bplan.plans[0], jm.bdev[0],
                              *(jnp.asarray(a) for a in args),
                              line_chunk=512)
    targs = [torch.as_tensor(a) for a in args]
    tab = banded.prep_layers(port64.bdev[0], *targs, use_kernel=False)
    np.testing.assert_allclose(tab["kmax"].numpy(), np.asarray(prep["kmax"]),
                               rtol=1e-14, atol=0)
    np.testing.assert_allclose(tab["coef0"].numpy(),
                               np.asarray(prep["coef_iso"]).T, rtol=1e-15)
    empty = {**port64.bdev[0],
             **{k: port64.bdev[0][k][:0] for k in
                ("all_wavn", "all_elow", "all_gf", "all_iso")}}
    jempty = {**jm.bdev[0], **{k: jm.bdev[0][k][:0] for k in
                               ("all_wavn", "all_elow", "all_gf",
                                "all_iso")}}
    kscan = jfast._kmax_scan(jempty, jnp.asarray(args[0]),
                             jnp.ones((jm.iso.mass.shape[0], 20)), 512,
                             jm.iso.mass.shape[0], jnp.float64)
    kport = banded.prep_layers(empty, *targs, use_kernel=False)["kmax"]
    assert np.array_equal(np.asarray(kscan), np.zeros(20))
    assert torch.equal(kport, torch.zeros(20, dtype=torch.float64))
    kw["ethresh"] = 2.0
    out = banded.plain_banded_extinction(port64.bplan, port64.bdev, *targs,
                                         **kw)
    assert out.shape == (20, jm.wns.n) and torch.count_nonzero(out) == 0


def test_split_far_false_matches_unbanded():
    """Banding alone changes nothing (tests/test_fast_and_forward.py's
    test_banded_matches_unbanded bound, 5e-7): the banded plan without
    far shells against the port's unbanded plain path."""
    cfg = port_config(make_config("eclipse", 1e30))
    mb = TransitModel(cfg, mode="fast",
                      dtype=torch.float64, device="cpu", bands=6,
                      split_far=False)
    m0 = TransitModel(cfg, mode="fast", dtype=torch.float64, device="cpu")
    assert mb.bplan.far_plans is None and len(mb.bplan.plans) >= 2
    args, kw = state(m0, np.float64)
    targs = [torch.as_tensor(a) for a in args]
    a = plain_extinction(m0.fplan, m0.fdev, *targs, **kw).numpy()
    b = banded.plain_banded_extinction(mb.bplan, mb.bdev, *targs,
                                       **kw).numpy()
    np.testing.assert_allclose(b, a, rtol=5e-7, atol=0)
    T, q = m0.atm.temp, m0.atm.q
    np.testing.assert_allclose(mb.forward(T, q).numpy(),
                               m0.forward(T, q).numpy(), rtol=5e-7)


def test_forward_matches_jax_banded_model(jax_banded, port64):
    """The port's TransitModel(bands=6).forward against JAX's, f64, on
    the file profile and a perturbed one made with numpy from a seed."""
    jm, _ = jax_banded
    rng = np.random.default_rng(5)
    fwd = jax.jit(jm.forward)
    profiles = [(jm.atm.temp, jm.atm.q),
                (jm.atm.temp + 40.0 + 10.0 * rng.standard_normal(20),
                 jm.atm.q * (1.0 + 0.1 * rng.uniform(-1, 1, jm.atm.q.shape)))]
    for T, q in profiles:
        ref = np.asarray(fwd(jnp.asarray(T), jnp.asarray(q)))
        got = port64.forward(T, q).numpy()
        assert got.shape == ref.shape and np.all(np.isfinite(got))
        assert rel(ref, got) <= 1e-10
