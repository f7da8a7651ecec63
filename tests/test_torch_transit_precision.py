"""Why the port builds the hydrostatic path weights in float64
(TransitModel.geometry): on a hot-Jupiter slice in transit geometry with
hydrostatic radii (chip_smoke.py's transit path at 3000-3020 cm-1, 41
wavenumbers, 100 layers), the float32 model's gradient in T under a
relative change of 1e-6 in the line extinction, with the path weights
built in float32 (as JAX builds them) and in float64 (the port), and
each gradient against the float64 model's.

    python -m tests.test_torch_transit_precision

prints the numbers.  Bounds: with float64 weights the gradient moves by
< 1e-5 of its max under the change (the kernel path against the plain
path differs by that much in the extinction) and stays within 2e-3 of
the float64 model's; with float32 weights it moves by > 1e-3."""

import numpy as np
import torch

from tests.test_torch_common import HJ
from transit_tpu_torch.config import TransitConfig
from transit_tpu_torch.model import TransitModel
from transit_tpu_torch.rt import geometry as rt_geom

torch.set_num_threads(1)


def _config():
    return TransitConfig(
        atm=f"{HJ}/hj.atm", linedb=f"{HJ}/hj.tli",
        csfile=f"{HJ}/cia_H2_H2.dat,{HJ}/cia_H2_He.dat",
        molfile=f"{HJ}/molecules.dat", wnlow=3000.0, wnhigh=3020.0,
        wndelt=0.5, wnosamp=2, wnfct=1.0, nwidth=20.0, ethreshold=1e-8,
        solution="transit", toomuch=20.0, gsurf=2479.0, refpress=1.0,
        refradius=73760.0)


def _grad(m, T0, q0, noise=0.0):
    """d(sum of forward) / dT, the line extinction scaled by
    1 + noise * N(0, 1) (numpy, seeded)."""
    ext = m.line_extinction
    if noise:
        def scaled(*a, **k):
            e = ext(*a, **k)
            r = np.random.default_rng(1).standard_normal(tuple(e.shape))
            return e * (1.0 + noise * torch.as_tensor(r, dtype=e.dtype))
        m.line_extinction = scaled
    try:
        T = torch.tensor(T0, dtype=m.dtype, requires_grad=True)
        return torch.autograd.grad(m.forward(T, q0).sum(), T)[0].double()
    finally:
        m.line_extinction = ext


def weights_precision() -> dict:
    """{variant: {"moved": max|g(noise) - g| / max|g|, "vs_float64":
    max|g - g64| / max|g64|}} for the path weights built in float64 (the
    port) and in float32."""
    m32 = TransitModel(_config(), mode="fast",
                       dtype=torch.float32, device="cpu",
                       bands=6)
    m64 = TransitModel(_config(), mode="fast",
                       dtype=torch.float64, device="cpu",
                       bands=6)
    T0 = np.asarray(m32.atm.temp, dtype=np.float64)
    q0 = np.asarray(m32.atm.q, dtype=np.float64)
    g64 = _grad(m64, T0, q0)

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    out = {}
    for variant in ("float64", "float32"):
        if variant == "float32":
            # The weights in the radii's dtype, as transit_tpu builds them:
            m32.geometry = lambda T, q: (lambda r: (
                r, rt_geom.transit_weights_torch(r),
                TransitModel.geometry(m32, T, q)[2]))(
                    TransitModel.geometry(m32, T, q)[0])
        g = _grad(m32, T0, q0)
        out[variant] = {"moved": rel(_grad(m32, T0, q0, 1e-6), g),
                        "vs_float64": rel(g, g64)}
    return out


def test_float64_path_weights_keep_the_gradient_stable():
    res = weights_precision()
    assert res["float64"]["moved"] < 1e-5, res
    assert res["float64"]["vs_float64"] < 2e-3, res
    assert res["float32"]["moved"] > 1e-3, res


if __name__ == "__main__":
    print(weights_precision())
