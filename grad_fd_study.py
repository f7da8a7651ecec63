"""Central differences in T against the port's gradient on a slice of the
hot-Jupiter files (benchmarks/data/hj), on the CPU in float64:

    python3 grad_fd_study.py [--threads 4]

The model is the main path's (bands=6, 0.5 cm-1), cut to 3000-3200
cm-1.  Its gradient, like jax.grad of the JAX model, holds two masks
fixed: the wing cutoff (a bin is inside a line's wing while |wn - wn0| <=
nwidth * max(alphaD, alphaL), and both widths move with T) and the
ethresh cut (a line is kept while its strength is >= ethresh * the
layer's kmax).  The spectrum jumps where a bin or a line crosses one of
them.  For layers 15-17 (the largest |dF/dT| at nwidth 20) the script
prints dF/dT, F = sum(forward), and the relative gap (gradient -
difference) / difference of central differences at steps of 5, 0.5 and
0.05 K: at nwidth 19, 20, 20.5 and 21 with ethresh 1e-8, and at nwidth
20 with ethresh 1e-300 (no line is cut).  A gap that shrinks with the
step and changes with nwidth, but not with ethresh, comes from bins
crossing the wing cutoff.  Imports no JAX; ~3 min on 4 cores.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from transit_tpu_torch.config import TransitConfig
from transit_tpu_torch.model import TransitModel

HJ = os.path.join(os.path.dirname(os.path.abspath(__file__)), "benchmarks",
                  "data", "hj")
LAYERS = (15, 16, 17)
STEPS = (5.0, 0.5, 0.05)
CASES = ((19.0, 1e-8), (20.0, 1e-8), (20.5, 1e-8), (21.0, 1e-8),
         (20.0, 1e-300))


def model(nwidth: float, ethresh: float) -> TransitModel:
    cfg = TransitConfig(
        atm=f"{HJ}/hj.atm", linedb=f"{HJ}/hj.tli",
        csfile=f"{HJ}/cia_H2_H2.dat,{HJ}/cia_H2_He.dat",
        molfile=f"{HJ}/molecules.dat", wnlow=3000.0, wnhigh=3200.0,
        wndelt=0.5, wnosamp=2160, wnfct=1.0, nwidth=nwidth,
        ethreshold=ethresh, solution="eclipse", toomuch=1e30)
    return TransitModel(cfg, mode="fast",
                        dtype=torch.float64, device="cpu", bands=6)


def case(nwidth: float, ethresh: float) -> dict:
    m = model(nwidth, ethresh)
    T0, q0 = m.atm.temp, m.atm.q
    T = torch.tensor(T0, requires_grad=True)
    gT, = torch.autograd.grad(m.forward(T, torch.tensor(q0)).sum(), T)
    out = {}
    with torch.no_grad():
        for layer in LAYERS:
            g = float(gT[layer])
            gaps = {}
            for h in STEPS:
                f = []
                for sign in (1.0, -1.0):
                    Tp = T0.copy()
                    Tp[layer] += sign * h
                    f.append(float(m.forward(Tp, q0).sum()))
                fd = (f[0] - f[1]) / (2.0 * h)
                gaps[h] = (g - fd) / fd
            out[layer] = {"T": float(T0[layer]), "grad": g, "gap": gaps}
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--threads", type=int, default=4)
    torch.set_num_threads(ap.parse_args().threads)
    for nwidth, ethresh in CASES:
        res = case(nwidth, ethresh)
        for layer, r in res.items():
            print(json.dumps({"nwidth": nwidth, "ethresh": ethresh,
                              "layer": layer, **r}), flush=True)


if __name__ == "__main__":
    main()
