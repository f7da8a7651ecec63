"""Exact mode's line extinction: the reference C code's profile-table
scheme (computemolext, extinction.c:281-529), plainly.

1. The co-add groups (extinction.c:430-462), from the lines alone: in
   file order (isotope, then wavelength), a group's primary is the first
   line not yet taken; out of [wn_i, last fine wavenumber] it stays
   alone, else it takes the following lines of its isotope while they
   lie within one fine spacing of the fine-grid point nearest to it.
2. Per row: the widths, the strengths, the row's largest strength over
   the in-range lines (the ethresh cut), each group's summed strength
   times its isotope's density (``g_k``, 0 where the group's sum is
   under the cut), the Lorentz index of each isotope and the Doppler
   index of each group (recomputed for a kept group whose Doppler width
   is at least a tenth of its Lorentz width, else the last such group's
   of its isotope, else the row's index at the first wavenumber).
3. Each kept group adds g_k times its profile's table values to the
   coarse bins whose fine wavenumber falls inside the profile (C
   truncating division for the window)."""

from __future__ import annotations

import numpy as np
import torch

from .constants import EXPCTE, SIGCTE
from .pairs import by_runs, chunks, expand, runs
from .physics import line_widths

# (row, group, bin) pairs added at once.
PAIR_BUDGET = {"cpu": 1 << 18, "cuda": 1 << 24}


def groups(wavn, isoid, wn_i: float, odwn: float, dwn: float, n_fine: int):
    """The co-add groups of lines in file order: (gid (n,), primary
    (ng,), inrange (ng,) bool, iown (ng,), idwn (ng,))."""
    n = wavn.shape[0]
    wn_top = wn_i + (n_fine - 1) * odwn
    iown = ((wavn - wn_i) / odwn).astype(np.int64)
    iown = np.clip(iown, 0, n_fine - 1)
    up = np.minimum(iown + 1, n_fine - 1)
    nearer = (iown + 1 < n_fine) & (np.abs(wavn - (wn_i + up * odwn)) <
                                    np.abs(wavn - (wn_i + iown * odwn)))
    iown = np.where(nearer, up, iown)
    center = wn_i + iown * odwn
    inrange = (wavn >= wn_i) & (wavn <= wn_top)
    # Where each line's group would end if it were a primary: the first
    # later line of another isotope, or whose wavenumber is at least a
    # fine spacing below the center (an isotope's wavenumbers descend).
    seg_end = np.r_[np.flatnonzero(np.diff(isoid)) + 1, n]
    end = seg_end[np.searchsorted(seg_end, np.arange(n), side="right")]
    nxt = np.empty(n, dtype=np.int64)
    for a, b in zip(np.r_[0, seg_end[:-1]], seg_end):
        neg = -wavn[a:b]
        nxt[a:b] = a + np.searchsorted(neg, odwn - center[a:b], side="left")
    idx = np.arange(n)
    nxt = np.minimum(np.maximum(nxt, idx + 1), end)
    # The search compares -wavn with odwn - center; the rule compares
    # |wavn - center| with odwn: settle the last bit at the boundary.
    b = np.maximum(nxt - 1, idx)
    out = (b > idx) & ~(np.abs(wavn[b] - center) < odwn)
    nxt = np.where(out, nxt - 1, nxt)
    b = np.minimum(nxt, n - 1)
    more = ((nxt < end) & (isoid[b] == isoid) &
            (np.abs(wavn[b] - center) < odwn))
    nxt = np.where(more, nxt + 1, nxt)
    nxt = np.where(inrange, nxt, idx + 1)
    # A run a line starts that is not a primary does not count; follow
    # the primaries from the first line:
    step, prim, i = nxt.tolist(), [], 0
    while i < n:
        prim.append(i)
        i = step[i]
    prim = np.array(prim, dtype=np.int64)
    gid = np.repeat(np.arange(prim.shape[0]), np.diff(np.r_[prim, n]))
    w = wavn[prim]
    ok = inrange[prim]
    return (gid, prim, ok, np.where(ok, iown[prim], 0),
            np.where(ok, ((w - wn_i) / dwn).astype(np.int64), 0))


class Plan:
    """The groups and tables of exact mode as tensors on ``device``."""

    def __init__(self, L, table, grid, ofactor, device, dtype):
        wn_i, dwn, nwn = grid
        wavn = L["wavn_np"]
        isoid = L["iso_np"]
        gid, prim, ok, iown, idwn = groups(
            wavn, isoid, wn_i, dwn / ofactor, dwn, (nwn - 1) * ofactor + 1)
        t = dict(device=device)
        self.gid = torch.as_tensor(gid, **t)
        self.g_inrange = torch.as_tensor(ok, **t)
        self.g_iso = torch.as_tensor(isoid[prim], **t)
        self.g_runs = runs(isoid[prim])
        self.g_wavn = torch.as_tensor(wavn[prim], dtype=dtype, **t)
        self.g_iown = torch.as_tensor(iown, **t)
        self.g_idwn = torch.as_tensor(idwn, **t)
        start = np.r_[True, isoid[prim][1:] != isoid[prim][:-1]]
        self.g_run_start = torch.as_tensor(
            np.maximum.accumulate(np.where(start, np.arange(prim.shape[0]),
                                           0)), **t)
        wn_top = wn_i + ((nwn - 1) * ofactor) * (dwn / ofactor)
        self.line_inrange = torch.as_tensor((wavn >= wn_i) &
                                            (wavn <= wn_top), **t)
        self.aDop = torch.as_tensor(table.aDop, dtype=dtype, **t)
        self.aLor = torch.as_tensor(table.aLor, dtype=dtype, **t)
        self.size = torch.as_tensor(table.size, **t)
        self.base = torch.as_tensor(table.base, **t)
        self.flat = torch.as_tensor(table.flat, dtype=dtype, **t)
        self.ofactor, self.nwn, self.wn0 = ofactor, nwn, wn_i
        self.ng = prim.shape[0]


def nearest(arr, v):
    """Index of the element of ascending ``arr`` nearest to v (ties to
    the lower index)."""
    hi = torch.searchsorted(arr, v.contiguous()).clamp(1, arr.shape[0] - 1)
    lo = hi - 1
    return torch.where((arr[hi] - v).abs() < (arr[lo] - v).abs(), hi, lo)


def row_groups(L, P: Plan, temps, densities, Z, ethresh):
    """Step 2 for the rows: (g_k (rows, ng), g_idop (rows, ng), ilor
    (rows, niso)); g_k is differentiable in temps, densities and Z."""
    rows = temps.shape[0]
    T = temps[:, None]
    alphal, alphad = line_widths(temps, densities, L["iso_mass"],
                                 L["iso_imol"], L["mol_mass"],
                                 L["mol_radius"])
    ilor = nearest(P.aLor, alphal)
    idop0 = nearest(P.aDop, alphad * P.wn0)
    s = L["gf"] * torch.exp(-EXPCTE * L["elow"] / T) * (
        1.0 - torch.exp(-EXPCTE * L["wavn"] / T))
    coef = SIGCTE * L["iso_ratio"] / L["iso_mass"]
    with torch.no_grad():
        k = s * coef[L["iso"]] / by_runs(Z.T, L["iso_runs"])
        kmax = torch.where(P.line_inrange, k, -torch.inf).amax(
            dim=1, keepdim=True).clamp_min(0.0)
    gsum = torch.zeros((rows, P.ng), dtype=s.dtype, device=s.device)
    gsum = gsum.index_add(1, P.gid, s)
    g_iso = P.g_iso
    g_k = gsum * coef[g_iso] / by_runs(Z.T, P.g_runs)
    keep = P.g_inrange & (g_k >= ethresh * kmax)
    dens = densities.T[:, L["iso_imol"]]                  # (rows, niso)
    g_k = torch.where(keep, g_k * by_runs(dens, P.g_runs), 0.0)
    with torch.no_grad():
        ad = alphad[:, g_iso] * P.g_wavn
        cond = keep & (ad / alphal[:, g_iso] >= 1e-1)
        at = nearest(P.aDop, ad)
        gidx = torch.arange(P.ng, device=s.device)
        last = torch.cummax(torch.where(cond, gidx, -1), dim=1).values
        valid = last >= P.g_run_start
        g_idop = torch.where(cond, at, torch.where(
            valid, at.gather(1, last.clamp_min(0)), idop0[:, g_iso]))
    return g_k, g_idop, ilor


def windows(P: Plan, g_k, g_idop, ilor):
    """Per kept (row, group): (row, group, first bin, bins, profile
    offset term) of the coarse bins its profile reaches: the bins j of
    [minj, maxj] (C truncating division, clipped to the grid) whose fine
    index ofactor j - (iown - psize) lies in [0, 2 psize]."""
    r, g = (g_k != 0).nonzero(as_tuple=True)
    il = ilor[r, P.g_iso[g]]
    idop = g_idop[r, g]
    psize = P.size[idop, il]
    of = P.ofactor
    iown, idwn = P.g_iown[g], P.g_idwn[g]
    subw = iown - idwn * of
    offset = iown - psize
    minj = (idwn - torch.div(psize - subw, of, rounding_mode="trunc")
            ).clamp_min(0)
    maxj = (idwn + torch.div(psize + subw, of, rounding_mode="trunc")
            ).clamp_max(P.nwn - 1)
    lo = torch.maximum(minj, -torch.div(-offset, of, rounding_mode="floor"))
    hi = torch.minimum(maxj, torch.div(offset + 2 * psize, of,
                                       rounding_mode="floor"))
    return r, g, lo, (hi - lo + 1).clamp_min(0), P.base[idop, il] - offset


def scatter(P: Plan, g_k, win):
    """Step 3: the line extinction (rows, nwn), differentiable in g_k."""
    r, g, lo, counts, tab0 = win
    rows = g_k.shape[0]
    out = torch.zeros(rows * P.nwn, dtype=g_k.dtype, device=g_k.device)
    flat_k = g_k.reshape(-1)
    at = r * P.ng + g
    for sl in chunks(counts, PAIR_BUDGET[g_k.device.type]):
        e, j = expand(lo[sl], counts[sl])
        e = e + sl.start
        # index_select: its backward adds, with no sort of the indices.
        val = flat_k.index_select(0, at[e]) * P.flat[tab0[e] + P.ofactor * j]
        out = out.index_add(0, r[e] * P.nwn + j, val)
    return out.reshape(rows, P.nwn)


def extinction(L, P: Plan, temps, densities, Z, ethresh):
    """Line extinction (rows, nwn) of the rows."""
    g_k, g_idop, ilor = row_groups(L, P, temps, densities, Z, ethresh)
    return scatter(P, g_k, windows(P, g_k, g_idop, ilor))


def scatter_work(L, P: Plan, temps, densities, Z, ethresh, seen,
                 used) -> dict:
    """Counts of what the scatter of these rows needs: ``kept``, the
    kept (row, group) entries; ``pairs``, their (row, group, bin) pairs.
    Marks in ``seen`` (bool, the table's length) the profile-table
    elements the pairs read and in ``used`` (bool, (ng,)) the groups
    with a kept row."""
    with torch.no_grad():
        g_k, g_idop, ilor = row_groups(L, P, temps, densities, Z, ethresh)
        r, g, lo, counts, tab0 = windows(P, g_k, g_idop, ilor)
        used |= (g_k != 0).any(dim=0)
        for sl in chunks(counts, PAIR_BUDGET[g_k.device.type]):
            e, j = expand(lo[sl], counts[sl])
            seen[tab0[e + sl.start] + P.ofactor * j] = True
        return {"kept": int(r.shape[0]), "pairs": int(counts.sum())}
