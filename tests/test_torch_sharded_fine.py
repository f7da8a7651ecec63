"""The port's sharded step on the fine-grid fixture (0.01 cm-1, where the
banded planner makes decimated far-wing shells with strides >= 4) against
JAX's sharded step and the port's single model, float64: JAX's own bound
for its sharded step against its single model is rtol 2e-6
(tests/test_sharded.py:148-171)."""

import jax.numpy as jnp
import numpy as np
import torch

from tests.test_fast_and_forward import _fine_grid_config
from tests.test_torch_sharded import NSHARD, _mesh, _port
from transit_tpu.model import TransitModel as JModel
from transit_tpu.parallel import sharded as jsharded
from transit_tpu_torch.parallel import sharded

torch.set_num_threads(1)


def test_sharded_decimated_shells_match_jax_and_single():
    jc = _fine_grid_config()
    m = _port(jc, 6)
    strides = [s for far in (m.bplan.far_plans or []) if far
               for (_l, _r, s) in far]
    assert strides and max(strides) >= 4
    T, q = torch.as_tensor(m.atm.temp), torch.as_tensor(m.atm.q)
    step = sharded.make_sharded_forward(m, nshard=NSHARD)
    got = step.assemble([step.local(s, T, q) for s in range(NSHARD)])
    np.testing.assert_allclose(got.numpy(), m.forward(T, q).numpy(),
                               rtol=2e-6, atol=0)
    jm = JModel(jc, mode="fast", bands=6)
    want = np.asarray(jsharded.make_sharded_forward(jm, _mesh())(
        jnp.asarray(jm.atm.temp), jnp.asarray(jm.atm.q)))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-6, atol=0)
