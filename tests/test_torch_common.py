"""Helpers shared by the port's test files (no tests here): configs,
the file-atmosphere state of a model, the JAX model's device arrays as
numpy, and the relative error the port's tests bound."""

import dataclasses
import os

import numpy as np
import torch

from tests.test_conformance import make_config
from transit_tpu.config import TransitConfig as JConfig
from transit_tpu_torch.config import TransitConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "benchmarks", "data")
HJ = os.path.join(DATA, "hj")


def fine_grid_config():
    """tests/test_fast_and_forward.py:261: the fixture at 0.01 cm-1 on
    2000-2040 cm-1 (4001 wavenumbers), where the banded planner makes
    decimated far-wing shells."""
    cfg = make_config("eclipse", 1e30)
    cfg.wnlow, cfg.wnhigh, cfg.wndelt = 2000.0, 2040.0, 0.01
    cfg.wnosamp = 2
    return cfg


def bench_config():
    """bench.py's standard workload files (benchmarks/data/bench.*)."""
    return JConfig(
        atm=f"{DATA}/bench.atm", linedb=f"{DATA}/bench.tli",
        csfile=f"{DATA}/bench_cia.dat", molfile=f"{DATA}/molecules.dat",
        wnlow=2000.0, wnhigh=2500.0, wndelt=0.25, wnosamp=216, wnfct=1.0,
        nwidth=20.0, ethreshold=1e-8, solution="eclipse", toomuch=1e30)


def hotjupiter_config(wndelt=0.5):
    """The hot-Jupiter workload (bench.py:208-240); at 0.05 cm-1 the
    oversampling is cut to 2 (fast mode does not read the fine grid)."""
    return JConfig(
        atm=f"{HJ}/hj.atm", linedb=f"{HJ}/hj.tli",
        csfile=f"{HJ}/cia_H2_H2.dat,{HJ}/cia_H2_He.dat",
        molfile=f"{HJ}/molecules.dat", wnlow=500.0, wnhigh=10000.0,
        wndelt=wndelt, wnosamp=2160 if wndelt >= 0.5 else 2, wnfct=1.0,
        nwidth=20.0, ethreshold=1e-8, solution="eclipse", toomuch=1e30)


def port_config(jcfg):
    return TransitConfig(**dataclasses.asdict(jcfg))


def state(m, dtype):
    """(temps_cgs, densities, Z, mol_mass, mol_radius), kw of the file
    atmosphere as numpy arrays in ``dtype``."""
    a = lambda v: np.asarray(v, dtype=dtype)
    kw = dict(wn_i=m.wns.i, dwn=m.wns.d, ethresh=m.cfg.ethreshold,
              nwidth=m.cfg.nwidth)
    return (a(m.atm.temp * m.atm.tfct), a(m.atm.d), a(m.Z_layers),
            a(m.mol.mass), a(m.mol.radius)), kw


def to_numpy(v, dtype=np.float64):
    """A JAX device-array tree (dicts, lists, tuples, None) as numpy,
    float arrays in ``dtype``."""
    if isinstance(v, dict):
        return {k: to_numpy(x, dtype) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(to_numpy(x, dtype) for x in v)
    if v is None:
        return None
    a = np.asarray(v)
    return a.astype(dtype) if a.dtype.kind == "f" else a


def torch_dtype(npdt):
    return torch.float64 if npdt == np.float64 else torch.float32


def rel(a, b):
    """max |a - b| / (|a| + 1e-6 max|a|), with a the reference."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / (np.abs(a) + 1e-6 *
                                         np.abs(a).max())))


def banded_pair(jcfg, npdt, far_full_res=False):
    """The JAX banded model (bands=6) of ``jcfg``, its device arrays as
    numpy in ``npdt``, the file-atmosphere state, and JAX's
    fast.banded_extinction on them (jitted: a cold eager call compiles
    every tile block on its own); the port's plain_banded_extinction on
    the same tile tensors, through convert.  -> (jm, ref, got)."""
    import jax
    import jax.numpy as jnp
    from transit_tpu.model import TransitModel as JModel
    from transit_tpu.opacities import fast as jfast
    from transit_tpu_torch.convert import device_arrays_from_numpy
    from transit_tpu_torch.model import TransitModel
    from transit_tpu_torch.opacities.banded import plain_banded_extinction

    jm = JModel(jcfg, mode="fast", bands=6)
    tm = TransitModel(port_config(jcfg), mode="fast", dtype=torch_dtype(npdt),
                      device="cpu", bands=6)
    args, kw = state(jm, npdt)
    dn = to_numpy(jm.bdev, npdt)
    fn = jax.jit(lambda dev, *a: jfast.banded_extinction(
        jm.bplan, dev, *a, far_full_res=far_full_res, **kw))
    ref = np.asarray(fn(jax.tree_util.tree_map(jnp.asarray, dn),
                        *(jnp.asarray(a) for a in args)))
    d = device_arrays_from_numpy(dn, dtype=torch_dtype(npdt), device="cpu")
    got = plain_banded_extinction(tm.bplan, d,
                                  *(torch.as_tensor(a) for a in args),
                                  far_full_res=far_full_res, **kw).numpy()
    return jm, ref, got

