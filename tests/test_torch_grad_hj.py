"""The port's gradient in T and q against jax.grad of the JAX model on
slices of the hot-Jupiter files (benchmarks/data/hj: 100 layers, 4
isotopes), float64, bands=6: the main path's 0.5 cm-1 grid on 3000-3020
cm-1 (near tile classes, stride-1 r2 shells) and the 0.05 cm-1 grid on
2000-2020 cm-1 (decimated asym2 shells at strides 2 and 4).  JAX's
gradient, like the port's, holds the wing cutoff and the ethresh cut
fixed; grad_fd_study.py shows how central differences across those
cuts depart from it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_common import hotjupiter_config, port_config
from transit_tpu.model import TransitModel as JModel
from transit_tpu_torch.model import TransitModel

torch.set_num_threads(1)


@pytest.mark.parametrize("wndelt,wnlow,wnhigh", [(0.5, 3000.0, 3020.0),
                                                 (0.05, 2000.0, 2020.0)],
                         ids=["main", "fine"])
def test_model_gradient_matches_jax_hot_jupiter_slice(wndelt, wnlow,
                                                      wnhigh):
    """max|a-b| <= 1e-9 max|b| for dF/dT and dF/dq, F = sum(forward)."""
    cfg = hotjupiter_config(wndelt)
    cfg.wnlow, cfg.wnhigh = wnlow, wnhigh
    jm = JModel(cfg, mode="fast", bands=6)
    fn = jax.jit(jax.grad(lambda t, q: jnp.sum(jm.forward(t, q)),
                          argnums=(0, 1)))
    ref = [np.asarray(a) for a in fn(jnp.asarray(jm.atm.temp),
                                     jnp.asarray(jm.atm.q))]
    m = TransitModel(port_config(cfg), dtype=torch.float64, device="cpu",
                     bands=6)
    shells = {(fp.wfn_tag, s) for far in m.bplan.far_plans if far
              for fp, _, s in far}
    assert shells == ({("r2", 1)} if wndelt == 0.5 else
                      {("r2", 1), ("asym2", 2), ("asym2", 4)})
    T = torch.tensor(m.atm.temp, requires_grad=True)
    q = torch.tensor(m.atm.q, requires_grad=True)
    got = torch.autograd.grad(m.forward(T, q).sum(), (T, q))
    for a, b in zip(got, ref):
        assert a.shape == b.shape and np.abs(b).max() > 0
        assert float(np.abs(a.numpy() - b).max()) <= 1e-9 * np.abs(b).max()
