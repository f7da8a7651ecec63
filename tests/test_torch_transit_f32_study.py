"""How far the float32 transit gradient lies from float64, in the port and
in the JAX package: on tests/test_torch_transit_precision.py's
hot-Jupiter slice (transit geometry, 3000-3020 cm-1, 100 layers, fast
mode, bands=6), with hydrostatic radii and with static radii, the
gradient of sum(forward(T, q)) in T and in q at the file's atmosphere:

  - the port's float32 model against the port's float64 model;
  - JAX's float32 model (jax_enable_x64 off: every array float32) and
    jitted, against the same float64 reference (the port's float64
    gradient equals jax.grad's in float64 within 1e-9 of its max:
    tests/test_torch_transit_hydro*.py, _transit_banded.py);
  - the port's float32 gradient against JAX's.

Each as max|a - b| / max|b|, per input.  A one-off study, not a test
(pytest collects nothing here; about a minute on one CPU core, most of
it JAX's compiles, run in a process of its own so that JAX stays in
float32):

    python -m tests.test_torch_transit_f32_study
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tests.test_torch_transit_precision import _config
from transit_tpu.config import TransitConfig as JConfig
from transit_tpu.model import TransitModel as JModel
from transit_tpu_torch.model import TransitModel

torch.set_num_threads(1)


def configs() -> dict:
    hydro = _config()
    static = dataclasses.replace(hydro, gsurf=None, refpress=None,
                                 refradius=None)
    return {"hydrostatic": hydro, "static": static}


def port_grad(cfg, dtype, T0, q0):
    m = TransitModel(cfg, mode="fast", dtype=dtype, device="cpu", bands=6)
    T = torch.tensor(T0, dtype=dtype, requires_grad=True)
    q = torch.tensor(q0, dtype=dtype, requires_grad=True)
    return [g.double().numpy() for g in
            torch.autograd.grad(m.forward(T, q).sum(), (T, q))]


def jax_grad(cfg, T0, q0):
    assert not jax.config.jax_enable_x64
    jm = JModel(JConfig(**dataclasses.asdict(cfg)), mode="fast", bands=6)
    assert jm.dtype == jnp.float32
    fn = jax.jit(jax.grad(lambda t, q: jnp.sum(jm.forward(t, q)),
                          argnums=(0, 1)))
    gT, gq = fn(jnp.asarray(T0, jnp.float32), jnp.asarray(q0, jnp.float32))
    assert gT.dtype == jnp.float32
    return [np.asarray(g, dtype=np.float64) for g in (gT, gq)]


def rel(a, b) -> float:
    return float(np.abs(a - b).max() / np.abs(b).max())


def study() -> dict:
    out = {}
    for name, cfg in configs().items():
        m = TransitModel(cfg, mode="fast", dtype=torch.float64,
                         device="cpu", bands=6)
        T0 = np.asarray(m.atm.temp, dtype=np.float64)
        q0 = np.asarray(m.atm.q, dtype=np.float64)
        g64 = port_grad(cfg, torch.float64, T0, q0)
        p32 = port_grad(cfg, torch.float32, T0, q0)
        j32 = jax_grad(cfg, T0, q0)
        out[name] = {
            f"{who}_{x}": rel(g[i], ref[i])
            for who, g, ref in (("port_f32_vs_f64", p32, g64),
                                ("jax_f32_vs_f64", j32, g64),
                                ("port_f32_vs_jax_f32", p32, j32))
            for i, x in enumerate(("T", "q"))}
    return out


if __name__ == "__main__":
    print(json.dumps(study(), indent=1))
