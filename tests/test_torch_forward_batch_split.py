"""forward_batch past the kernels' int32 index limit: the batch runs as
sub-batches below it (model.INDEX_LIMIT, lowered here so that a batch of
3 fixture profiles splits into three), and the spectra and their
gradient in T and q equal one pass's (float64, bands=6 and unbanded, to
1e-12 of their max: the sub-batches' vmapped products may sum in
another order)."""

import numpy as np
import pytest
import torch

from tests.test_conformance import make_config
from tests.test_torch_common import port_config
from transit_tpu_torch import model as model_module
from transit_tpu_torch.model import TransitModel

torch.set_num_threads(1)


@pytest.mark.parametrize("bands", [6, 0], ids=["bands6", "unbanded"])
def test_split_batch_equals_one_pass(monkeypatch, bands):
    m = TransitModel(port_config(make_config("eclipse", 1e30)), mode="fast",
                     dtype=torch.float64, device="cpu", bands=bands)
    rng = np.random.default_rng(13)
    T = np.stack([m.atm.temp + rng.normal(0.0, 5.0, m.atm.nlayers)
                  for _ in range(3)])
    q = np.stack([m.atm.q * (1.0 + 0.05 * rng.uniform(-1, 1, m.atm.q.shape))
                  for _ in range(3)])

    def run():
        Tt, qt = (torch.tensor(a, requires_grad=True) for a in (T, q))
        spec = m.forward_batch(Tt, qt)
        return (spec.detach(), *torch.autograd.grad(spec.sum(), (Tt, qt)))

    one = run()
    assert m.batch_splits(3) == [(0, 3)]
    monkeypatch.setattr(model_module, "INDEX_LIMIT",
                        2 * m.atm.nlayers * m.wns.n)
    assert m.batch_splits(3) == [(0, 1), (1, 2), (2, 3)]
    split = run()
    for a, b in zip(split, one):
        assert a.shape == b.shape and float(b.abs().max()) > 0
        assert float((a - b).abs().max()) <= 1e-12 * float(b.abs().max())
