"""The Adam temperature recovery of tests/test_retrieval.py:47 through
the port's differentiable forward with torch.optim.Adam, float64 on the
CPU, bands=4 on the fixture's first 41 wavenumbers (cut from 101 for the
CPU; 300 steps at lr 2e-2 as the JAX test): the loss must fall by 1e4,
>= 80% of the layers come back within 1%, the median within 3e-3."""

import numpy as np
import torch

from tests.test_conformance import make_config
from tests.test_torch_common import port_config
from transit_tpu_torch.model import TransitModel

torch.set_num_threads(1)

WNHIGH_ADAM = 2040.0


def test_adam_recovers_temperature_profile():
    """Inject T*, start from a profile 8% off, recover it by gradient
    descent on the emission spectrum (bands=4, as the JAX test)."""
    cfg = make_config("eclipse", 1e30)
    cfg.wnhigh = WNHIGH_ADAM
    m = TransitModel(port_config(cfg), dtype=torch.float64, device="cpu",
                     bands=4)
    t_true = torch.as_tensor(m.atm.temp)
    q = torch.as_tensor(m.atm.q)
    target = m.forward(t_true, q)
    norm = torch.mean(target ** 2)
    x = torch.log(t_true * 1.08).requires_grad_(True)
    opt = torch.optim.Adam([x], lr=2e-2)
    losses = []
    for _ in range(300):
        opt.zero_grad()
        loss = torch.mean((m.forward(torch.exp(x), q) - target) ** 2) / norm
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    with torch.no_grad():
        final = float(torch.mean((m.forward(torch.exp(x), q) - target) ** 2)
                      / norm)
    assert final < 1e-4 * losses[0], (losses[0], final)
    rel = np.abs(torch.exp(x).detach().numpy() / t_true.numpy() - 1.0)
    assert np.mean(rel < 0.01) >= 0.8, rel
    assert np.median(rel) < 3e-3, np.median(rel)
