"""Fast mode's line extinction, summed pair by pair.

For each row (a layer of one profile) the config's rule keeps a line when
its strength k0 = gf e^(-c2 El/T) (1 - e^(-c2 nu/T)) SIGCTE ratio /
(mass Z) is at least ``ethresh`` times the row's largest over all lines;
a kept line adds k0 dens K(x, y) / alphaD to every grid wavenumber within
``nwidth`` max(alphaD, alphaL) of its center, K the w4 Voigt function
(x = sqrt(ln2) |wn - nu| / alphaD, y = sqrt(ln2) alphaL / alphaD).  No
tiles, bands, far-wing shells or decimation: every such (line,
wavenumber) pair is evaluated."""

from __future__ import annotations

import torch

from .constants import EXPCTE, SIGCTE, SQRTLN2
from .pairs import by_runs, chunks, expand
from .physics import line_widths
from .voigt import VoigtK, humlicek_region

# (line, wavenumber) pairs evaluated at once.
PAIR_BUDGET = {"cpu": 1 << 18, "cuda": 1 << 22}


def strengths(L, temps, Z):
    """k0 (rows, lines) of the rows' temperatures (K) and partition
    functions Z (niso, rows)."""
    T = temps[:, None]
    s = L["gf"] * torch.exp(-EXPCTE * L["elow"] / T) * (
        1.0 - torch.exp(-EXPCTE * L["wavn"] / T))
    coef = SIGCTE * L["iso_ratio"][None, :] / (L["iso_mass"][None, :] * Z.T)
    return s * by_runs(coef, L["iso_runs"])


def entries(L, temps, densities, Z, nwidth, ethresh):
    """The kept (row, line) entries: (row, line, k0 dens, alphaD,
    alphaL, wing half width), each (m,); differentiable in the rows'
    temperatures, densities and Z."""
    k0 = strengths(L, temps, Z)
    with torch.no_grad():
        keep = k0 >= ethresh * k0.amax(dim=1, keepdim=True)
    r, line = keep.nonzero(as_tuple=True)
    alphal, alphad_f = line_widths(temps, densities, L["iso_mass"],
                                   L["iso_imol"], L["mol_mass"],
                                   L["mol_radius"])
    runs = L["iso_runs"]
    # Per (row, line) tables, then each entry's by a flat index_select:
    # the backward sums each isotope run and adds each entry once, with
    # no sort of indices.
    at = r * k0.shape[1] + line
    dens = by_runs(densities.T[:, L["iso_imol"]], runs)

    def pick(x):
        return x.reshape(-1).index_select(0, at)
    ad = pick(by_runs(alphad_f, runs) * L["wavn"])
    al = pick(by_runs(alphal, runs))
    return (r, line, pick(k0 * dens), ad, al,
            nwidth * torch.maximum(ad, al))


def pair_chunks(L, ent, grid):
    """The (entry, wavenumber) pairs of the entries ``ent`` in chunks:
    yields (e, j, dist), each (p,): the entry, the grid index and
    |wn_j - nu| of every pair inside the entry's wing."""
    r, line, _, _, _, wing = ent
    wn0, dwn, nwn = grid
    wv = L["wavn"][line].detach()
    w = wing.detach()
    # Positions are the configuration's data: the bins to test (one more
    # on each side) and each pair's distance from float64 positions, the
    # distance then in the model's dtype.
    wv64, w64 = L["wavn_f64"][line], w.double()
    lo = torch.floor((wv64 - w64 - wn0) / dwn).long().clamp_min(0)
    hi = torch.ceil((wv64 + w64 - wn0) / dwn).long().clamp_max(nwn - 1)
    counts = (hi - lo + 1).clamp_min(0)
    budget = PAIR_BUDGET[wv.device.type]
    for sl in chunks(counts, budget):
        e, j = expand(lo[sl], counts[sl])
        e = e + sl.start
        dist = (wn0 + j * dwn - wv64[e]).abs().to(wv.dtype)
        ok = dist <= w[e]
        yield e[ok], j[ok], dist[ok]


def extinction(L, temps, densities, Z, grid, nwidth, ethresh):
    """Line extinction (rows, nwn) of the rows."""
    rows, nwn = temps.shape[0], grid[2]
    ent = entries(L, temps, densities, Z, nwidth, ethresh)
    r, _, kd, ad, al, _ = ent
    out = torch.zeros(rows * nwn, dtype=temps.dtype, device=temps.device)
    for e, j, dist in pair_chunks(L, ent, grid):
        inv = 1.0 / ad[e]
        x = (SQRTLN2 * dist * inv).clamp_max(1e8)
        y = SQRTLN2 * al[e] * inv
        out = out.index_add(0, r[e] * nwn + j, kd[e] * VoigtK.apply(x, y) *
                            inv)
    return out.reshape(rows, nwn)


def pair_regions(L, temps, densities, Z, grid, nwidth, ethresh) -> dict:
    """Counts of the work the rows need: ``entries``, the kept (row,
    line) entries, and the pairs inside their wings by the w4 region of
    their (x, y): ``II``, ``III``, ``IV``."""
    with torch.no_grad():
        ent = entries(L, temps, densities, Z, nwidth, ethresh)
        _, _, _, ad, al, _ = ent
        out = {"entries": int(ad.shape[0]), "II": 0, "III": 0, "IV": 0}
        for e, _, dist in pair_chunks(L, ent, grid):
            reg = humlicek_region(SQRTLN2 * dist / ad[e],
                                  SQRTLN2 * al[e] / ad[e])
            for k, name in ((2, "II"), (3, "III"), (4, "IV")):
                out[name] += int((reg == k).sum())
    return out
