"""Line-by-line extinction of exact mode: the reference's profile-table
scheme (transit_tpu.opacities.lbl; the C code's computemolext,
extinction.c:281-529).

  1. A host-side, temperature-independent *line plan* (:func:`plan_lines`,
     lbl.py:62): nearest fine-bin index per line, the sequential co-add
     group partition (extinction.c:449-462: the groups depend only on the
     wavelengths and the grid) and the coarse-bin scatter geometry.
  2. The per-layer computation (lbl.py:161), here batched over a chunk
     of layers at a time (JAX maps over single layers with ``lax.map``;
     :func:`chunk_rows` sizes the chunks): widths, line strengths, the
     per-species max strength for the ethresh cut (extinction.c:400-427),
     the co-add sums per group, the ``keep`` mask (extinction.c:467-470),
     the forward fill of the Doppler index (extinction.c:479-483), in
     torch ops (:func:`layer_groups`); then the windowed gather of each
     kept group's bin-averaged profile from the flat table and its
     scatter-add onto the coarse grid (lbl.py:245-271).  On the card the
     Doppler fill and the scatter are the hand-written kernels
     ``doppler_fill`` and ``profile_scatter``
     (opacities/kernel_profile.py); :func:`doppler_fill_plain` and
     :func:`profile_scatter_plain` are their plain PyTorch versions, and
     :func:`profile_scatter_plain_vjp` that of the scatter's backward.

The numerics are the reference's: the same profile table, the same co-add
order, the same integer index arithmetic with C truncating division.  The
gradient flows, as in JAX, only through the group strengths g_k: the
profile indices are integers.  Per-molecule output (``permol``, the
opacity-grid build, lbl.py:208-225 and :269-271): kmax per output
molecule, no density factor, one output row per molecule
(:func:`layer_groups` with ``nm``, :func:`permol_tables`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from transit_tpu_torch import _native
from transit_tpu_torch.constants import EXPCTE, SIGCTE
from transit_tpu_torch.numerics.search import nearest_index_torch
from transit_tpu_torch.opacities.fast import _layer_widths
from transit_tpu_torch.opacities.voigt import ProfileTable
from transit_tpu_torch.utils.log import span

# (layer, group, window) entries the plain scatter holds at once, by
# device (its temporaries: ~40 bytes an entry).
PLAIN_ENTRIES = {"cpu": 1 << 18, "cuda": 1 << 25}

# (row, line) entries of one chunk of layer_groups rows, by device: its
# group tables hold ~15 tensors of (rows, lines or groups).  Exact mode's
# line extinction (layer_extinction: rows are layers) and the exact grid
# build (grid.exact_chunks: rows are (layer, temperature) cells) take
# their rows in chunks of this many entries (chunk_rows).
GROUP_ROW_ENTRIES = {"cpu": 1 << 22, "cuda": 1 << 26}

# Columns of one segment of row_cummax.
CUMMAX_SEGMENT = 4096

# Groups a tile of the profile-scatter kernels holds at most: one thread
# each (csrc/profile_scatter.cu PS_TILE).
SCATTER_TILE = 256
# Bins of a tile's span the kernels stage in shared memory; a wider span
# works on global memory (csrc/profile_scatter.cu PS_SEG).
SCATTER_SEGMENT = 2048


@dataclasses.dataclass
class IsoConst:
    """Per-isotope static data."""
    mass: np.ndarray      # (niso,) amu
    ratio: np.ndarray     # (niso,) isotopic abundance ratio
    imol: np.ndarray      # (niso,) molecule index in the atmosphere
    iout: np.ndarray      # (niso,) output-species index (permol mode)
    nmol_out: int         # number of output species


@dataclasses.dataclass
class LinePlan:
    """Temperature-independent per-line/per-group data (host precompute;
    lbl.py:35)."""
    # Per line (sorted by isotope then wavelength, i.e. file order):
    wavn: np.ndarray       # (nl,) line-center wavenumber, cm-1
    isoid: np.ndarray      # (nl,) int32
    elow: np.ndarray       # (nl,)
    gf: np.ndarray         # (nl,)
    gid: np.ndarray        # (nl,) co-add group id
    inrange: np.ndarray    # (nl,) bool, per-line [wns.i, owns[-1]] check
    # Per group:
    g_primary: np.ndarray  # (ng,) line index of the group's primary
    g_inrange: np.ndarray  # (ng,) bool: primary passed the range check
    g_iown: np.ndarray     # (ng,) nearest oversampled-bin index
    g_idwn: np.ndarray     # (ng,) coarse-bin index (C truncation)
    n_coarse: int          # output wavenumber count
    ofactor: int           # oversampling factor

    @property
    def n_lines(self):
        return self.wavn.shape[0]

    @property
    def n_groups(self):
        return self.g_primary.shape[0]


def group_partition_plain(wavn, isoid, owns_v, wn_i: float, odwn: float,
                          dwn: float, wn_top: float):
    """The co-add group partition of the sorted lines, the scalar loop of
    computemolext's pass 2 (extinction.c:430-462) on Python floats (IEEE
    doubles, the same arithmetic as numpy's float64 scalars):

      - primary line: first unconsumed line; skipped if out of
        [wns.i, owns[-1]] (still forms a singleton group).
      - consume following lines of the same isotope while their wavenumber
        is within odwn of the primary's grid point owns[iown].

    Returns (gid int32 (n,), primary int32 (ng,), inrange bool (ng,),
    iown int64 (ng,), idwn int64 (ng,)).  The plain version of
    :func:`transit_tpu_torch._native.group_partition`."""
    n = len(wavn)
    onwn = owns_v.shape[0]
    wv = np.asarray(wavn, dtype=np.float64).tolist()
    iso = np.asarray(isoid, dtype=np.int32).tolist()
    gid = np.zeros(n, dtype=np.int32)
    g_primary, g_inrange, g_iown, g_idwn = [], [], [], []
    i = 0
    while i < n:
        g = len(g_primary)
        w = wv[i]
        gid[i] = g
        g_primary.append(i)
        if w < wn_i or w > wn_top:
            g_inrange.append(False)
            g_iown.append(0)
            g_idwn.append(0)
            i += 1
            continue
        iown = int((w - wn_i) / odwn)
        if (iown + 1 < onwn and
                abs(w - owns_v[iown + 1]) < abs(w - owns_v[iown])):
            iown += 1
        center = float(owns_v[iown])
        j = i + 1
        while j < n and iso[j] == iso[i] and abs(wv[j] - center) < odwn:
            j += 1
        gid[i + 1:j] = g
        g_inrange.append(True)
        g_iown.append(iown)
        g_idwn.append(int((w - wn_i) / dwn))
        i = j
    return (gid, np.asarray(g_primary, dtype=np.int32),
            np.asarray(g_inrange, dtype=bool),
            np.asarray(g_iown, dtype=np.int64),
            np.asarray(g_idwn, dtype=np.int64))


def _plan(partition, wl, isoid, elow, gf, wfct: float, wn_i: float,
          odwn: float, dwn: float, owns_v, n_coarse: int,
          ofactor: int) -> LinePlan:
    """The line plan with the co-add groups of ``partition``."""
    wl = np.asarray(wl, dtype=np.float64)
    wavn = 1.0 / (wl * wfct)
    isoid = np.asarray(isoid, dtype=np.int32)
    wn_top = float(owns_v[-1])
    gid, g_primary, g_inrange, g_iown, g_idwn = partition(
        wavn, isoid, owns_v, wn_i, odwn, dwn, wn_top)
    return LinePlan(
        wavn=wavn, isoid=isoid,
        elow=np.asarray(elow, dtype=np.float64),
        gf=np.asarray(gf, dtype=np.float64),
        gid=gid,
        inrange=(wavn >= wn_i) & (wavn <= wn_top),
        g_primary=g_primary, g_inrange=g_inrange, g_iown=g_iown,
        g_idwn=g_idwn, n_coarse=n_coarse, ofactor=ofactor)


def plan_lines(wl: np.ndarray, isoid: np.ndarray, elow: np.ndarray,
               gf: np.ndarray, wfct: float,
               wn_i: float, odwn: float, dwn: float,
               owns_v: np.ndarray, n_coarse: int, ofactor: int) -> LinePlan:
    """Build the line plan (lbl.py:62); the co-add groups come from the
    native partition (:func:`transit_tpu_torch._native.group_partition`,
    lbl.py:80-98), bit for bit :func:`plan_lines_plain`'s."""
    return _plan(_native.group_partition, wl, isoid, elow, gf, wfct, wn_i,
                 odwn, dwn, owns_v, n_coarse, ofactor)


def plan_lines_plain(wl: np.ndarray, isoid: np.ndarray, elow: np.ndarray,
                     gf: np.ndarray, wfct: float,
                     wn_i: float, odwn: float, dwn: float,
                     owns_v: np.ndarray, n_coarse: int,
                     ofactor: int) -> LinePlan:
    """:func:`plan_lines` with the Python loop
    (:func:`group_partition_plain`): its plain version."""
    return _plan(group_partition_plain, wl, isoid, elow, gf, wfct, wn_i,
                 odwn, dwn, owns_v, n_coarse, ofactor)


def _run_starts(g_iso) -> np.ndarray:
    """Per group (``g_iso`` (ng,) their isotopes), whether it starts its
    isotope's contiguous run."""
    g_iso = np.asarray(g_iso)
    new = np.ones(g_iso.shape[0], dtype=bool)
    new[1:] = g_iso[1:] != g_iso[:-1]
    return new


def iso_run_start(plan: LinePlan) -> np.ndarray:
    """Per group, the first group of its isotope's contiguous run (the
    loop at lbl.py:280-282, vectorised)."""
    new = _run_starts(plan.isoid[plan.g_primary])
    return np.maximum.accumulate(np.where(new, np.arange(new.shape[0]),
                                          0)).astype(np.int32)


def scatter_tiles(g_iso, tile: int = SCATTER_TILE) -> np.ndarray:
    """The profile-scatter kernels' tile table: int32 group starts
    (ntiles + 1,), from 0 to ng, of tiles of at most ``tile`` consecutive
    groups, cut at every isotope run's start (a run is the groups of one
    isotope in a row, ``g_iso`` (ng,) their isotopes), so that no tile
    crosses a run."""
    starts = np.flatnonzero(_run_starts(g_iso))
    ng = len(g_iso)
    ends = np.append(starts[1:], ng)
    return np.concatenate([np.arange(a, b, tile) for a, b in
                           zip(starts, ends)] + [[ng]]).astype(np.int32)


def check_tiles(tiles, ng: int) -> None:
    """Raise ValueError unless ``tiles`` is a tile table of ``ng`` groups
    the kernels can take: 1-d group starts from 0 to ng, ascending, no
    tile empty or longer than SCATTER_TILE (a longer one would drop
    groups)."""
    tiles = np.asarray(tiles)
    if tiles.ndim != 1 or tiles.shape[0] < 2:
        raise ValueError("tiles must be (ntiles + 1,) group starts")
    if tiles[0] != 0 or tiles[-1] != ng:
        raise ValueError(f"tiles must run from 0 to ng = {ng}, not from "
                         f"{tiles[0]} to {tiles[-1]}")
    sizes = np.diff(tiles.astype(np.int64))
    if sizes.min() < 1 or sizes.max() > SCATTER_TILE:
        raise ValueError(f"tiles must hold 1 to {SCATTER_TILE} groups "
                         f"each, not {sizes.min()} to {sizes.max()}")


def _int32(a, name: str) -> np.ndarray:
    """A host integer array as int32, checked to fit: the kernels take
    int32 indices."""
    a = np.asarray(a)
    if a.size and (a.min() < -2 ** 31 or a.max() >= 2 ** 31):
        raise ValueError(f"{name} does not fit the kernels' int32 indices")
    return a.astype(np.int32)


def device_arrays(plan: LinePlan, iso: IsoConst, table: ProfileTable,
                  dtype=torch.float64, device="cpu") -> dict:
    """The static line, isotope and table data as tensors on ``device``
    (lbl.py:274): the keys of JAX's dict, floats in ``dtype``, indices
    int32 (the profile table's ``profflat`` float32 by contract), plus
    ``g_iso`` and ``g_wavn``, the isotope and wavenumber of each group's
    primary line, and ``g_tiles``, the scatter kernels' tile table
    (:func:`scatter_tiles`)."""
    def f(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=dtype,
                               device=device)

    def i32(a, name):
        return torch.as_tensor(_int32(a, name), device=device)

    def b(a):
        return torch.as_tensor(np.asarray(a, dtype=bool), device=device)

    if table.flat.shape[0] >= 2 ** 31:
        raise ValueError("the profile table does not fit the kernels' int32 "
                         "indices")
    return {
        "wavn": f(plan.wavn), "elow": f(plan.elow), "gf": f(plan.gf),
        "line_iso": i32(plan.isoid, "isoid"),
        "line_iout": i32(iso.iout[plan.isoid], "iout"),
        "line_inrange": b(plan.inrange),
        "gid": i32(plan.gid, "gid"),
        "g_primary": i32(plan.g_primary, "g_primary"),
        "g_inrange": b(plan.g_inrange),
        "g_iown": i32(plan.g_iown, "g_iown"),
        "g_idwn": i32(plan.g_idwn, "g_idwn"),
        "g_iso_start": i32(iso_run_start(plan), "g_iso_start"),
        "g_iso": i32(plan.isoid[plan.g_primary], "g_iso"),
        "g_wavn": f(plan.wavn[plan.g_primary]),
        "g_tiles": i32(scatter_tiles(plan.isoid[plan.g_primary]),
                       "g_tiles"),
        "iso_mass": f(iso.mass), "iso_ratio": f(iso.ratio),
        "iso_imol": i32(iso.imol, "imol"),
        "aDop": f(table.aDop), "aLor": f(table.aLor),
        "profsize": i32(table.profsize, "profsize"),
        "profbase": i32(table.base, "profbase"),
        "profflat": torch.as_tensor(np.asarray(table.flat, np.float32),
                                    device=device),
    }


@dataclasses.dataclass
class ScatterTables:
    """What the profile scatter reads besides the per-(layer, group)
    strengths and indices: per group its isotope, nearest fine bin and
    coarse bin (int32, (ng,)); the table's half sizes and bases (int32,
    (ndop, nlor)) and its flat float32 profiles; the oversampling factor
    and the coarse grid's length; the kernels' tile table (int32
    (ntiles + 1,), :func:`scatter_tiles`)."""
    g_iso: torch.Tensor
    g_iown: torch.Tensor
    g_idwn: torch.Tensor
    profsize: torch.Tensor
    profbase: torch.Tensor
    profflat: torch.Tensor
    ofactor: int
    n_coarse: int
    tiles: torch.Tensor
    # Per-molecule output (:func:`permol_tables`): nm output rows a layer,
    # per group its row g_mol (ng,) and per tile tile_mol (ntiles,),
    # int32; None and 1 for the collapsed extinction.
    g_mol: torch.Tensor | None = None
    tile_mol: torch.Tensor | None = None
    nm: int = 1


def scatter_tables(plan: LinePlan, d: dict) -> ScatterTables:
    """The :class:`ScatterTables` of a plan and its :func:`device_arrays`."""
    return ScatterTables(g_iso=d["g_iso"], g_iown=d["g_iown"],
                         g_idwn=d["g_idwn"], profsize=d["profsize"],
                         profbase=d["profbase"], profflat=d["profflat"],
                         ofactor=plan.ofactor, n_coarse=plan.n_coarse,
                         tiles=d["g_tiles"])


def permol_tables(s: ScatterTables, line_iout, g_primary,
                  nm: int) -> ScatterTables:
    """``s`` with per-molecule output rows: each group's output molecule
    (that of its primary line, ``line_iout`` (nlines,) and ``g_primary``
    (ng,) int tensors) and each tile's, ``nm`` of them.  Raises
    ValueError when a tile's groups go to two molecules (lbl.scatter_tiles
    never cuts an isotope run, and an isotope has one molecule) or a
    molecule lies outside [0, nm)."""
    g_mol = line_iout.long()[g_primary.long()]
    tiles = s.tiles.long()
    gm = g_mol.cpu().numpy()
    first = gm[tiles[:-1].cpu().numpy()]
    sizes = (tiles[1:] - tiles[:-1]).cpu().numpy()
    if gm.size and (gm.min() < 0 or gm.max() >= nm):
        raise ValueError(f"output molecules must lie in [0, {nm})")
    if not (gm == first.repeat(sizes)).all():
        raise ValueError("a scatter tile mixes output molecules")
    dev = s.tiles.device
    return dataclasses.replace(
        s, g_mol=g_mol.to(torch.int32), nm=nm,
        tile_mol=torch.as_tensor(first.astype(np.int32), device=dev))


def chunk_rows(plan: LinePlan, device, n_out: int,
               rows: int | None = None) -> int:
    """Rows of one chunk of :func:`layer_groups` on ``device``: ``rows``,
    by default GROUP_ROW_ENTRIES of the device's type over the plan's
    line (or group) count; at least 1, and few enough that a chunk's
    ``n_out`` outputs a row stay below the kernels' int32 indices
    (model.INDEX_LIMIT)."""
    from transit_tpu_torch.model import INDEX_LIMIT

    if rows is None:
        rows = (GROUP_ROW_ENTRIES[torch.device(device).type] //
                max(plan.n_lines, plan.n_groups, 1))
    return int(np.clip(rows, 1, max(1, (INDEX_LIMIT - 1) // n_out)))


def row_slices(n: int, rows: int) -> list:
    """Consecutive slices of ``rows`` of n rows, the last one short."""
    return [slice(a, min(a + rows, n)) for a in range(0, n, rows)]


def group_runs(d: dict) -> tuple:
    """(isotope, its molecule, first group, end group) of each run of
    consecutive groups of one isotope (the plan sorts the lines by
    isotope), from d["g_iso"] and d["iso_imol"]: read to the host at the
    first call for that g_iso tensor and kept on it, so a warm step
    (a CUDA graph's capture) reads nothing back."""
    g_iso = d["g_iso"]
    runs = getattr(g_iso, "_group_runs", None)
    if runs is None:
        g = g_iso.cpu().numpy()
        imol = d["iso_imol"].cpu().numpy()
        cut = np.flatnonzero(np.diff(g)) + 1
        runs = tuple((int(g[a]), int(imol[g[a]]), int(a), int(b)) for a, b
                     in zip(np.r_[0, cut], np.r_[cut, g.shape[0]]))
        g_iso._group_runs = runs
    return runs


def run_columns(x, runs) -> torch.Tensor:
    """x[:, idx] (n, groups) for the runs [(column, first group, end
    group)] covering the groups in order: each run's column of x (n, k)
    expanded over its groups.  The backward sums each run, a reduction
    (an indexing gather's backward, on the card, sorts the groups and adds
    a column's ~ng/niso of them one after another, a time that does not
    shrink with the rows)."""
    n = x.shape[0]
    return torch.cat([x[:, c:c + 1].expand(n, b - a) for c, a, b in runs],
                     dim=1)


def row_cummax(x):
    """torch.cummax(x, dim=1).values of an integer (n, m) tensor, in
    segments of CUMMAX_SEGMENT columns: each segment's running max, then each
    row's running max over the segments' last values carried into the
    next segment (max is exact, so the bits are cummax's).  A scan along
    a row runs serially on the card, so m columns in one piece take a
    time that does not shrink with the rows; segments give it n * m /
    seg rows to run in parallel."""
    n, m = x.shape
    seg = CUMMAX_SEGMENT
    if m <= seg:
        return torch.cummax(x, dim=1).values
    k = -(-m // seg)
    low = torch.iinfo(x.dtype).min
    xp = torch.nn.functional.pad(x, (0, k * seg - m), value=low)
    local = torch.cummax(xp.reshape(n * k, seg), dim=1).values.reshape(
        n, k, seg)
    carry = torch.cummax(local[:, :, -1], dim=1).values[:, :-1]
    carry = torch.nn.functional.pad(carry, (1, 0), value=low)
    return torch.maximum(local, carry[:, :, None]).reshape(n, k * seg)[:, :m]


def layer_groups(d: dict, temps, densities, Z, mol_mass, mol_radius,
                 wn0: float, ethresh: float, nm: int | None = None,
                 use_kernel: bool = True) -> dict:
    """Everything of lbl.layer_extinction before the scatter (lbl.py:183-243),
    for the layers (rows) it is given, each row on its own (per-row max,
    co-add sums and forward fill: a chunk of rows gives the bits of the
    same rows among all layers): temps (nl,) cgs, densities (nmol, nl), Z
    (niso, nl) -> {"g_k": (nl, ng) group strength x density, 0 where the
    group is not kept; "keep": (nl, ng) bool; "g_idop": (nl, ng) int32
    Doppler index of the group's profile; "ilor": (nl, niso) int32
    Lorentz index}.  Differentiable in temps, densities and Z through
    g_k.  ``nm`` (permol, the grid build): the ethresh cut against the
    max over each of the ``nm`` output molecules' lines (d["line_iout"])
    and no density factor on g_k (the densities still set the widths).
    The Doppler fill is kernel_profile.doppler_fill_fn: the kernel on a
    CUDA device with ``use_kernel``, else :func:`doppler_fill_plain`.
    Spans: ``groups.strengths`` (the widths and pass 1),
    ``groups.coadd`` (pass 2 and ``keep``), ``groups.doppler``."""
    dt = d["wavn"].dtype
    ng = d["g_iso"].shape[0]
    nl = temps.shape[0]
    with span("groups.strengths"):
        T = temps[:, None]
        g_iso = d["g_iso"].long()
        line_iso = d["line_iso"].long()

        # Per-isotope widths (extinction.c:364-395):
        alphal, alphad = _layer_widths(temps, densities, d["iso_mass"],
                                       d["iso_imol"].long(), mol_mass,
                                       mol_radius)             # (nl, niso)
        idop0 = nearest_index_torch(d["aDop"], alphad * wn0)
        ilor = nearest_index_torch(d["aLor"], alphal)

        # Pass 1, the max line strength for the ethresh cut
        # (extinction.c:400-427): JAX's segment_max over the one
        # collapsed species is the max over the in-range lines, floored
        # at 0 (permol: over each output molecule's lines); it only sets
        # ``keep``, so it carries no gradient.
        strength = (d["gf"] * torch.exp(-EXPCTE * d["elow"] / T) *
                    (1.0 - torch.exp(-EXPCTE * d["wavn"] / T)))
        # strength: (nl, nlines)
        coef = d["iso_ratio"][line_iso] * SIGCTE
        with torch.no_grad():
            k_full = coef * strength / (d["iso_mass"][line_iso] *
                                        Z.T[:, line_iso])
            k_in = torch.where(d["line_inrange"], k_full, -torch.inf)
            if nm is None:
                kmax = torch.clamp_min(k_in.amax(dim=1, keepdim=True),
                                       0.0)
            else:
                # One masked max per molecule (nm is a few), not a
                # scatter_reduce: its atomics would all land on nm cells
                # a layer.
                line_m = d["line_iout"].long()
                kmax = torch.clamp_min(torch.stack(
                    [torch.where(line_m == m, k_in, -torch.inf).amax(dim=1)
                     for m in range(nm)], dim=1), 0.0)
                kmax = kmax[:, line_m[d["g_primary"].long()]]  # (nl, ng)

    with span("groups.coadd"):
        # Pass 2, the co-add groups' strengths (extinction.c:449-464).  Z
        # and the densities reach the groups through their isotope runs
        # (:func:`run_columns`), whose backward sums each run.
        runs = group_runs(d)
        gsum = torch.zeros((nl, ng), dtype=dt,
                           device=temps.device).index_add(1, d["gid"],
                                                          strength)
        g_k = gsum * SIGCTE * d["iso_ratio"][g_iso] / (
            d["iso_mass"][g_iso] * run_columns(Z.T, [(i, a, b)
                                                     for i, _, a, b
                                                     in runs]))
        keep = d["g_inrange"] & (g_k >= ethresh * kmax)
        if nm is None:
            g_k = g_k * run_columns(densities.T, [(m, a, b)
                                                  for _, m, a, b in runs])

    with span("groups.doppler"):
        # Imported here: kernel_profile imports this module.
        from transit_tpu_torch.opacities.kernel_profile import \
            doppler_fill_fn

        g_idop = doppler_fill_fn(keep, alphad, alphal, idop0, d,
                                 use_kernel=use_kernel)
        return {"g_k": torch.where(keep, g_k, 0.0), "keep": keep,
                "g_idop": g_idop, "ilor": ilor.to(torch.int32)}


def doppler_fill_plain(keep, alphad, alphal, idop0, g_iso, g_wavn,
                       g_iso_start, aDop):
    """The Doppler index's forward fill (extinction.c:479-483) of the rows
    of keep (rows, ng) bool, from the rows' widths alphad and alphal
    (rows, niso) and initial indices idop0 (rows, niso), and the plan's
    g_iso, g_wavn and g_iso_start (ng,) and aDop: kept groups with
    alphad*wavn/alphal >= 0.1 recompute the nearest aDop index; later
    groups of the same isotope run take the last recomputed value, others
    the row's initial index.  Returns g_idop (rows, ng) int32.  The plain
    PyTorch version of kernel_profile.doppler_fill."""
    ng = g_iso.shape[0]
    g_iso = g_iso.long()
    aD_g = alphad[:, g_iso] * g_wavn
    cond = keep & (aD_g / alphal[:, g_iso] >= 1e-1)
    gidx = torch.arange(ng, device=keep.device)
    ff = row_cummax(torch.where(cond, gidx, -1))
    ff_valid = ff >= g_iso_start
    idop_at = nearest_index_torch(aDop, aD_g)
    g_idop = torch.where(cond, idop_at, torch.where(
        ff_valid, idop_at.gather(1, ff.clamp(0, ng - 1)), idop0[:, g_iso]))
    return g_idop.to(torch.int32)


def scatter_geometry(g_idop, ilor, s: ScatterTables):
    """Per (layer, group), as int64: the profile's half size psize, its
    base in the flat table, offset = iown - psize and the clipped coarse
    window [minj, maxj] (lbl.py:246-256; C truncating division: psize -
    subw can be negative)."""
    nl, ng = g_idop.shape
    g_iso = s.g_iso.long()
    il = ilor.long().gather(1, g_iso.expand(nl, ng))
    idop = g_idop.long()
    psize = s.profsize.long()[idop, il]
    pbase = s.profbase.long()[idop, il]
    iown, idwn, of = s.g_iown.long(), s.g_idwn.long(), s.ofactor
    subw = iown - idwn * of
    offset = iown - psize
    minj = idwn - torch.div(psize - subw, of, rounding_mode="trunc")
    maxj = idwn + torch.div(psize + subw, of, rounding_mode="trunc")
    return (psize, pbase, offset, torch.clamp_min(minj, 0),
            torch.clamp_max(maxj, s.n_coarse - 1))


def scatter_pairs(g_k, g_idop, ilor, s: ScatterTables) -> int:
    """The (layer, group, j) pairs the scatter adds on this data: over
    the groups with g_k != 0, the coarse bins j of [minj, maxj] whose fine
    index ofactor*j - offset lies in [0, 2 psize] (the kernel's pair
    counter counts the same)."""
    psize, _, offset, minj, maxj = scatter_geometry(g_idop, ilor, s)
    of = s.ofactor
    lo = torch.maximum(minj, -torch.div(-offset, of, rounding_mode="floor"))
    hi = torch.minimum(maxj, torch.div(offset + 2 * psize, of,
                                       rounding_mode="floor"))
    return int(torch.where(g_k != 0, (hi - lo + 1).clamp_min(0), 0).sum())


def tile_spans(mask, g_idop, ilor, s: ScatterTables) -> torch.Tensor:
    """The bins each (layer, tile) of the kernels spans, (nl, ntiles)
    int64: from the lowest first to the highest last bin of the windows
    of the tile's groups that ``mask`` (nl, ng) selects, 0 for a tile
    with none (the kernels stage a span of at most SCATTER_SEGMENT bins
    in shared memory, and work on a longer one in global memory)."""
    _, _, _, minj, maxj = scatter_geometry(g_idop, ilor, s)
    live = mask & (minj <= maxj)
    big = torch.iinfo(torch.int64).max
    tiles = s.tiles.long()
    tile_of = torch.repeat_interleave(
        torch.arange(tiles.shape[0] - 1, device=tiles.device),
        tiles[1:] - tiles[:-1])
    shape = (mask.shape[0], tiles.shape[0] - 1)
    lo = torch.full(shape, big, dtype=torch.int64, device=mask.device)
    hi = torch.full(shape, -1, dtype=torch.int64, device=mask.device)
    idx = tile_of.expand(mask.shape)
    lo = lo.scatter_reduce(1, idx, torch.where(live, minj, big), "amin")
    hi = hi.scatter_reduce(1, idx, torch.where(live, maxj, -1), "amax")
    return torch.where(hi >= 0, hi - lo + 1, 0)


def _windows(mask, geom, s: ScatterTables, budget: int):
    """Walk the (layer, group) entries of ``mask`` by window width, the
    widest first (a stable sort), in chunks of at most ``budget``
    (entry, window) elements: yields (l, g, j, ok, gval) with l, g (m,)
    the entries, j (m, w) their coarse bins from minj on, ``ok`` the bins
    inside [minj, maxj] whose fine index lies in [0, 2 psize], gval
    (m, w) float32 the profile values there (the clips and masks of
    lbl.py:258-266, each chunk's window its widest entry's)."""
    psize, pbase, offset, minj, maxj = geom
    l, g = mask.nonzero(as_tuple=True)
    span = (maxj - minj + 1)[l, g].clamp_min(0)
    span, order = torch.sort(span, descending=True, stable=True)
    l, g = l[order], g[order]
    n, i = span.shape[0], 0
    last = s.profflat.shape[0] - 1
    while i < n and int(span[i]) > 0:
        w = int(span[i])
        m = max(1, budget // w)
        ll, gg = l[i:i + m], g[i:i + m]
        j = minj[ll, gg][:, None] + torch.arange(w, device=l.device)
        fidx = s.ofactor * j - offset[ll, gg][:, None]
        ok = ((j <= maxj[ll, gg][:, None]) & (fidx >= 0) &
              (fidx <= 2 * psize[ll, gg][:, None]))
        gval = s.profflat[torch.clamp(pbase[ll, gg][:, None] + fidx, 0,
                                      last)]
        yield ll, gg, j.clamp(0, s.n_coarse - 1), ok, gval
        i += m


def profile_scatter_plain(g_k, g_idop, ilor, s: ScatterTables,
                          budget: int | None = None):
    """The windowed gather and scatter-add of exact mode (lbl.py:245-271)
    for all layers: out[l, j] = sum over the groups with g_k != 0 and the
    bins j of their window of g_k[l, g] * profflat[pbase + ofactor*j -
    offset], (nl, n_coarse) in g_k's dtype; with per-molecule rows
    (s.g_mol, :func:`permol_tables`) out[l, g_mol[g], j], (nl, nm,
    n_coarse).  JAX's dense window, walked by :func:`_windows` in chunks
    of ``budget`` elements (default PLAIN_ENTRIES of the device) whose
    window is their widest entry's; the chunks add in one order whatever
    the budget.  The plain PyTorch version of
    kernel_profile.profile_scatter."""
    nl = g_k.shape[0]
    budget = budget or PLAIN_ENTRIES[g_k.device.type]
    out = torch.zeros(nl * s.nm * s.n_coarse, dtype=g_k.dtype,
                      device=g_k.device)
    geom = scatter_geometry(g_idop, ilor, s)
    for l, g, j, ok, gval in _windows(g_k != 0, geom, s, budget):
        contrib = torch.where(ok, g_k[l, g][:, None] * gval.to(g_k.dtype),
                              0.0)
        row = l if s.g_mol is None else l * s.nm + s.g_mol[g].long()
        out.index_add_(0, (row[:, None] * s.n_coarse + j).flatten(),
                       contrib.flatten())
    if s.g_mol is None:
        return out.reshape(nl, s.n_coarse)
    return out.reshape(nl, s.nm, s.n_coarse)


def profile_scatter_plain_vjp(ct, keep, g_idop, ilor, s: ScatterTables,
                              budget: int | None = None):
    """The VJP of :func:`profile_scatter_plain` in g_k: the cotangent
    ``ct`` (nl, n_coarse) -> grad[l, g] = sum over the group's window of
    profflat[pbase + fidx] * ct[l, j] for the kept groups, 0 for the
    others, (nl, ng) in ct's dtype.  The plain PyTorch version of
    kernel_profile.profile_scatter_backward."""
    nl, ng = keep.shape
    budget = budget or PLAIN_ENTRIES[ct.device.type]
    grad = torch.zeros((nl, ng), dtype=ct.dtype, device=ct.device)
    flat = ct.reshape(-1)
    geom = scatter_geometry(g_idop, ilor, s)
    for l, g, j, ok, gval in _windows(keep, geom, s, budget):
        term = torch.where(ok, gval.to(ct.dtype) *
                           flat[l[:, None] * s.n_coarse + j], 0.0)
        acc = term[:, 0]
        for k in range(1, term.shape[1]):    # bin after bin: the sum does
            acc = acc + term[:, k]           # not depend on the window
        grad[l, g] = acc
    return grad


def layer_extinction(plan: LinePlan, d: dict, temps, densities, Z,
                     mol_mass, mol_radius, wn0: float, ethresh: float,
                     use_kernel: bool = True, nm: int | None = None,
                     rows: int | None = None):
    """Line extinction (nlayer, n_coarse) of exact mode (lbl.layer_extinction,
    lbl.py:161, collapsed over species, which JAX maps over the layers):
    the group tables (:func:`layer_groups`), then the profile scatter, a
    chunk of layers at a time (:func:`chunk_rows`; ``rows`` sets the
    chunk), differentiable in temps, densities and Z (the
    ``profile_scatter`` kernels on the card, the plain versions on the
    CPU or with ``use_kernel=False``).  Layers that fit one chunk go
    through kernel_profile.ProfileScatter, autograd keeping the group
    tables for the backward; more go through
    kernel_profile.ChunkedExtinction, one launch a chunk, whose backward
    recomputes a chunk's tables at a time (under torch.func.vmap the
    batch folds into the rows, and those are chunked).  ``wn0``: the
    first coarse wavenumber (the initial Doppler index,
    extinction.c:393).  ``nm``: per-molecule output (permol, the grid
    build), (nlayer, nm, n_coarse) per unit density of each of the nm
    output molecules, without gradient
    (kernel_profile.profile_scatter_permol)."""
    # Imported here: kernel_profile imports this module's plain versions.
    from transit_tpu_torch.opacities.kernel_profile import (
        ChunkedExtinction, LayerChunks, profile_scatter_fn,
        profile_scatter_permol)

    nl = temps.shape[0]
    rows = chunk_rows(plan, temps.device, plan.n_coarse * (nm or 1), rows)
    s = scatter_tables(plan, d)
    if nm is not None:
        sp = permol_tables(s, d["line_iout"], d["g_primary"], nm)
        parts = [profile_scatter_permol(layer_groups(
            d, temps[sl], densities[:, sl], Z[:, sl], mol_mass, mol_radius,
            wn0, ethresh, nm=nm, use_kernel=use_kernel), sp,
            use_kernel=use_kernel)
            for sl in row_slices(nl, rows)]
        return parts[0] if len(parts) == 1 else torch.cat(parts)
    if rows >= nl:
        grp = layer_groups(d, temps, densities, Z, mol_mass, mol_radius,
                           wn0, ethresh, use_kernel=use_kernel)
        with span("scatter"):
            return profile_scatter_fn(grp, s, use_kernel=use_kernel)
    op = LayerChunks(d=d, s=s, mol_mass=mol_mass, mol_radius=mol_radius,
                     wn0=wn0, ethresh=ethresh, rows=rows,
                     kernel=use_kernel and temps.device.type == "cuda")
    return ChunkedExtinction.apply(temps, densities, Z, op)
