"""The Voigt pair's precision in the backward, measured on the main
path's hot-Jupiter slice (benchmarks/data/hj, 3000-3020 cm-1 at 0.5
cm-1, bands=6: near tile classes and stride-1 r2 shells); the 0.05 cm-1
slice is in test_torch_grad_precision_fine.py.

The port's model in float32 on the CPU (plain forward, plain VJPs), with
the pair w, its Faddeeva partials and the per-pair terms in float32 (the
forward's dtype, as fast._block_val_bwd computes them and the backward
kernels do) or in float64 (kernel_lbl.PAIR_DTYPE), the sums over pairs
in float64 either way.  Each is compared, as max|a-b| / max|b|:
  * float32 pair against float64 pair, per output of the line
    extinction's VJP (temps, coef0, densm, alphal, alphad_f) at the
    cotangent the spectrum's sum gives it, and chained to T and q;
  * both against jax.grad of the JAX model in float64 and in float32,
    chained to T and q.

``python -m tests.test_torch_grad_precision_main`` prints the numbers."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tests.test_torch_common import hotjupiter_config, port_config
from transit_tpu.model import TransitModel as JModel
from transit_tpu_torch.model import TransitModel
from transit_tpu_torch.opacities import banded, kernel_lbl

torch.set_num_threads(1)

OUTPUTS = ("temps", "coef0", "densm", "alphal", "alphad_f")
# The gates of chip_smoke.py the float32 pair must meet: the whole
# gradient against the float64 plain path, and each backward launch
# against its plain VJP.
GRAD_TOL = 1e-3
GRAD_LAUNCH_TOL = 1e-4


def max_rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _line_cotangent(m, T, q):
    """d(sum of the spectrum) / d(line extinction) at (T, q)."""
    T, q, dens = m._profiles(T, q)
    ex = m.line_extinction(T * m.atm.tfct, dens, m.partition(T)).detach()
    ex.requires_grad_(True)
    g, = torch.autograd.grad(m._assemble(T, q, dens, ex, False).sum(), ex)
    return g


JAX_DTYPES = {"jax64": jnp.float64, "jax32": jnp.float32}


def precision_study(wndelt: float, wnlow: float, wnhigh: float,
                    jax_refs=tuple(JAX_DTYPES)) -> dict:
    """The comparisons of the module docstring on one slice, against the
    JAX gradients ``jax_refs``: {"pair32 vs pair64": {output: x},
    "<pair> vs <jax>": {"T": x, "q": x}}."""
    cfg = hotjupiter_config(wndelt)
    cfg.wnlow, cfg.wnhigh = wnlow, wnhigh
    ref = {}
    for name in jax_refs:
        dt = JAX_DTYPES[name]
        jm = JModel(cfg, dtype=dt, mode="fast", bands=6)
        fn = jax.jit(jax.grad(lambda t, q: jnp.sum(jm.forward(t, q)),
                              argnums=(0, 1)))
        ref[name] = [np.asarray(a, np.float64) for a in fn(
            jnp.asarray(jm.atm.temp, dt), jnp.asarray(jm.atm.q, dt))]
    m = TransitModel(port_config(cfg), mode="fast",
                     dtype=torch.float32, device="cpu",
                     bands=6)
    T0, q0 = m._t(m.atm.temp), m._t(m.atm.q)
    g = _line_cotangent(m, T0, q0)
    _, dens = m._profiles(T0, q0)[1:]
    temps = T0 * m.atm.tfct
    tab = banded.prep_layers(m.bdev[0], temps, dens, m.partition(T0),
                             m._molm_t, m._molrad_t, use_kernel=False)
    kw = dict(wn_i=m.wns.i, dwn=m.wns.d, ethresh=m.cfg.ethreshold,
              nwidth=m.cfg.nwidth)
    got, raw = {}, {}
    saved = kernel_lbl.PAIR_DTYPE
    for name, pair in (("pair32", torch.float32), ("pair64", torch.float64)):
        kernel_lbl.PAIR_DTYPE = pair
        try:
            T = T0.clone().requires_grad_(True)
            q = q0.clone().requires_grad_(True)
            got[name] = [a.double().numpy() for a in torch.autograd.grad(
                m.forward(T, q).sum(), (T, q))]
            raw[name] = banded.plain_bands_vjp(m.bplan, m.bdev, tab, temps,
                                               g, kw)
        finally:
            kernel_lbl.PAIR_DTYPE = saved
    out = {"pair32 vs pair64": {
        **{k: max_rel(raw["pair32"][k], raw["pair64"][k]) for k in OUTPUTS},
        "T": max_rel(got["pair32"][0], got["pair64"][0]),
        "q": max_rel(got["pair32"][1], got["pair64"][1])}}
    for p in got:
        for j in ref:
            out[f"{p} vs {j}"] = {"T": max_rel(got[p][0], ref[j][0]),
                                  "q": max_rel(got[p][1], ref[j][1])}
    return out


def check_study(res: dict):
    """What the study measured (the module docstring's comparisons), to
    the bounds below: the float32 pair against the float64 pair, chained
    to T and q and on the outputs fed by the sums s1 and s3, well inside
    chip_smoke.py's gates; the alphaD cotangent (sum s2) within 1e-3 (on
    the main slice 2.2e-4: float32 rounding noise, so a kernel must round
    its float32 pair as the plain VJP does to stay within the 1e-4 a
    launch is held to); both pairs at float32 rounding from JAX's float32
    gradient, and at the float32 model's distance (<= 1.5e-2) from JAX's
    float64 one."""
    p = res["pair32 vs pair64"]
    assert max(p["T"], p["q"]) < 1e-5 < GRAD_TOL, p
    assert max(p[k] for k in ("temps", "coef0", "densm")) < 1e-5, p
    assert p["alphal"] < 5e-5 < GRAD_LAUNCH_TOL, p
    assert p["alphad_f"] < 1e-3, p
    for ref, bound in (("jax32", 1e-5), ("jax64", 2e-2)):
        for pair in ("pair32", "pair64"):
            key = f"{pair} vs {ref}"
            if key in res:
                assert max(res[key].values()) < bound, res


MAIN = (0.5, 3000.0, 3020.0)


def test_float32_pair_main_slice():
    res = precision_study(*MAIN)
    check_study(res)
    assert res["pair32 vs pair64"]["alphad_f"] > GRAD_LAUNCH_TOL, res


if __name__ == "__main__":
    import tests.conftest  # noqa: F401  (JAX on the CPU, float64 enabled)
    from tests.test_torch_grad_precision_fine import FINE

    for label, sl in (("main", MAIN), ("0.05 cm-1", FINE)):
        print(label, json.dumps(precision_study(*sl)), flush=True)
