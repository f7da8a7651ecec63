"""plain_extinction (the line-tile kernel's plain version) against the
Pallas kernel run in interpret mode on the same state, float64.  Moved
out of tests/test_torch_kernel_lbl.py, one case per file, so that each
file stays short on its test worker."""


import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_conformance import make_config
from tests.test_torch_common import rel as _rel, state as _state, to_numpy
from transit_tpu.model import TransitModel as JModel
from transit_tpu.opacities.pallas_lbl import pallas_extinction
from transit_tpu_torch.convert import device_arrays_from_numpy
from transit_tpu_torch.opacities.kernel_lbl import plain_extinction

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def fixture_pair():
    return JModel(make_config("eclipse", 1e30), mode="fast"), None


@pytest.mark.parametrize("npdt,tol", [(np.float64, 1e-12)])
def test_plain_matches_pallas_interpret(fixture_pair, npdt, tol):
    """Identical state into both: the JAX model's tile tensors (through
    convert) and the file atmosphere; 20 layers, not a multiple of the
    Pallas kernel's 8-layer block."""
    jm, _ = fixture_pair
    args, kw = _state(jm, npdt)
    d_np = to_numpy(jm.fdev, npdt)
    ref = np.asarray(pallas_extinction(
        jm.fplan, {k: jnp.asarray(v) for k, v in d_np.items()},
        *(jnp.asarray(a) for a in args), interpret=True, **kw))
    tdt = torch.float64 if npdt == np.float64 else torch.float32
    d = device_arrays_from_numpy(d_np, dtype=tdt, device="cpu")
    got = plain_extinction(jm.fplan, d, *(torch.as_tensor(a) for a in args),
                           **kw).numpy()
    assert got.shape == ref.shape == (20, jm.wns.n)
    assert got.dtype == npdt
    assert np.all(np.isfinite(got)) and np.all(got >= 0)
    assert got.max() > 0
    assert _rel(ref.astype(np.float64), got.astype(np.float64)) < tol
