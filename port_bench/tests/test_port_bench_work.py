"""The roofline work counts (reference.fast.pair_regions,
reference.exact.scatter_work) against brute-force counts, loop by loop,
on a tiny list: the first lines of the hot-Jupiter slice and three
layers."""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from port_bench.harness.spec import ROOT
from port_bench.reference import exact, fast
from port_bench.reference.constants import SQRTLN2
from port_bench.reference.inputs import load_problem
from port_bench.reference.model import Reference
from port_bench.tests.cells import config

torch.set_num_threads(1)
ROWS = slice(40, 43)


def _tiny(name: str, n: int) -> Reference:
    cfg = config(name)
    prob = load_problem(cfg, ROOT)
    prob = dataclasses.replace(prob, lines=tuple(a[:n] for a in prob.lines))
    return Reference(prob, torch.device("cpu"))


def _rows(ref):
    T = torch.as_tensor(ref.atm.temp[ROWS])
    q = torch.as_tensor(ref.atm.q)
    dens = ref.densities(torch.as_tensor(ref.atm.temp), q)[:, ROWS]
    return T, dens, ref.partition(T)


def test_fast_pairs_brute_force():
    ref = _tiny("hj_fast", 60)
    T, dens, Z = _rows(ref)
    c = ref.c
    got = fast.pair_regions(ref.L, T, dens, Z, ref.grid, c["nwidth"],
                            c["ethreshold"])
    k0 = fast.strengths(ref.L, T, Z)
    from port_bench.reference.physics import line_widths
    al, adf = line_widths(T, dens, ref.L["iso_mass"], ref.L["iso_imol"],
                          ref.L["mol_mass"], ref.L["mol_radius"])
    wn0, dwn, nwn = ref.grid
    want = {"entries": 0, "II": 0, "III": 0, "IV": 0}
    for r in range(T.shape[0]):
        kmax = float(k0[r].max())
        for i in range(k0.shape[1]):
            if float(k0[r, i]) < c["ethreshold"] * kmax:
                continue
            want["entries"] += 1
            iso = int(ref.L["iso"][i])
            wv = float(ref.L["wavn_f64"][i])
            ad = float(adf[r, iso]) * float(ref.L["wavn"][i])
            aL = float(al[r, iso])
            wing = c["nwidth"] * max(ad, aL)
            for j in range(nwn):
                d = abs(wn0 + j * dwn - wv)
                if d > wing:
                    continue
                x, y = SQRTLN2 * d / ad, SQRTLN2 * aL / ad
                if x + y >= 5.5:
                    want["II"] += 1
                elif y < 0.195 * x - 0.176:
                    want["IV"] += 1
                else:
                    want["III"] += 1
    assert got == want
    assert want["II"] + want["III"] + want["IV"] > 0


def test_scatter_work_brute_force():
    ref = _tiny("hj_exact_4m9", 80)
    T, dens, Z = _rows(ref)
    P = ref.plan
    seen = torch.zeros(P.flat.shape[0], dtype=torch.bool)
    used = torch.zeros(P.ng, dtype=torch.bool)
    got = exact.scatter_work(ref.L, P, T, dens, Z, ref.c["ethreshold"],
                             seen, used)
    g_k, g_idop, ilor = exact.row_groups(ref.L, P, T, dens, Z,
                                         ref.c["ethreshold"])
    of, nwn = P.ofactor, P.nwn
    kept = pairs = 0
    mark, groups = set(), set()
    for r in range(g_k.shape[0]):
        for g in range(P.ng):
            if float(g_k[r, g]) == 0.0:
                continue
            kept += 1
            groups.add(g)
            il = int(ilor[r, int(P.g_iso[g])])
            idop = int(g_idop[r, g])
            psize, base = int(P.size[idop, il]), int(P.base[idop, il])
            iown, idwn = int(P.g_iown[g]), int(P.g_idwn[g])
            subw = iown - idwn * of
            offset = iown - psize
            # C truncating division for the window's ends:
            minj = max(0, idwn - int(math.trunc((psize - subw) / of)))
            maxj = min(nwn - 1, idwn + int(math.trunc((psize + subw) / of)))
            for j in range(minj, maxj + 1):
                f = of * j - offset
                if 0 <= f <= 2 * psize:
                    pairs += 1
                    mark.add(base + f)
    assert got == {"kept": kept, "pairs": pairs}
    assert int(seen.sum()) == len(mark) and int(used.sum()) == len(groups)
    assert np.array_equal(np.flatnonzero(seen.numpy()), sorted(mark))
    assert pairs > 0
