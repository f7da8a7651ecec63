"""Opacity-grid subsystem: build, store, load, interpolate — the
counterpart of transit_tpu.opacities.grid.

Reference: transit/src/opacity.c (calcopacity/readopacity, binary layout
opacity.c:406-421) and extinction.c:534-581 (interpolmolext).  The grid is a
4-D table [Nlayer][Ntemp][Nmol][Nwave] of per-molecule extinction (without
the density factor); at run time each layer linearly interpolates in
temperature and multiplies by the molecular density
(:func:`grid_extinction`, torch ops on the model's device).

Two builders, both over all (layer, temperature) cells as pseudo-layers:
  - :func:`build_opacity_grid`, exact (permol): the reference's profile
    table through lbl.layer_groups(nm=...) and the per-molecule
    ``profile_scatter`` kernel (kernel_profile.profile_scatter_permol), in
    chunks of cells sized by an element budget;
  - :func:`build_opacity_grid_fast`: per output molecule a banded plan
    over the cells (fast.make_banded_plans, max_bands 4, far-wing shells)
    and the banded kernels at unit density (``line_tile_extinction``,
    ``layer_kmax``, ``shell_tile_extinction``; banded._launch_all), all of
    a band's cells in one launch.
On the CPU (or with use_kernel=False) the kernels' plain versions run.

File format (little-endian, identical to the reference):
    i64 x4  Nmol, Ntemp, Nlayer, Nwave
    i32[Nmol]  universal molecule IDs
    f64[Ntemp] temperatures (K)
    f64[Nlayer] pressures (cgs, barye)
    f64[Nwave] wavenumbers (cm-1)
    f64[Nlayer][Ntemp][Nmol][Nwave] opacity grid
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from transit_tpu_torch.constants import AMU, KB, LS, PI, SQRTLN2, \
    TLI_WAV_UNITS
from transit_tpu_torch.grids import make_temp_sampling
from transit_tpu_torch.io.tli import select_lines
from transit_tpu_torch.numerics.search import nearest_index_torch
from transit_tpu_torch.numerics.spline import splinterp_np
from transit_tpu_torch.opacities import banded, fast, lbl


@dataclasses.dataclass
class OpacityGrid:
    molID: np.ndarray    # (Nmol,) int32 universal molecule IDs
    temp: np.ndarray     # (Ntemp,)
    press: np.ndarray    # (Nlayer,) cgs
    wns: np.ndarray      # (Nwave,)
    grid: np.ndarray     # (Nlayer, Ntemp, Nmol, Nwave)


def write_opacity_grid(path: str, og: OpacityGrid):
    with open(path, "wb") as f:
        dims = np.array([og.molID.shape[0], og.temp.shape[0],
                         og.press.shape[0], og.wns.shape[0]], dtype="<i8")
        f.write(dims.tobytes())
        f.write(np.asarray(og.molID, dtype="<i4").tobytes())
        f.write(np.asarray(og.temp, dtype="<f8").tobytes())
        f.write(np.asarray(og.press, dtype="<f8").tobytes())
        f.write(np.asarray(og.wns, dtype="<f8").tobytes())
        f.write(np.asarray(og.grid, dtype="<f8").tobytes())


def read_opacity_grid(path: str, wn_window=None) -> OpacityGrid:
    """Read a grid file; ``wn_window=(b0, b1)`` loads only wavenumber
    columns [b0, b1) via memmap (one process's band of a multi-process
    run: each reads only its band's bytes)."""
    with open(path, "rb") as f:
        hdr = f.read(32)
        nmol, ntemp, nlayer, nwave = np.frombuffer(hdr, "<i8", 4, 0)
        molID = np.frombuffer(f.read(4 * nmol), "<i4").copy()
        temp = np.frombuffer(f.read(8 * ntemp), "<f8").copy()
        press = np.frombuffer(f.read(8 * nlayer), "<f8").copy()
        wns = np.frombuffer(f.read(8 * nwave), "<f8").copy()
        off = f.tell()
    mm = np.memmap(path, dtype="<f8", mode="r", offset=off,
                   shape=(nlayer, ntemp, nmol, nwave))
    if wn_window is not None:
        b0, b1 = wn_window
        grid = np.asarray(mm[:, :, :, b0:b1])
        wns = wns[b0:b1]
    else:
        grid = np.asarray(mm)
    return OpacityGrid(molID=molID, temp=temp, press=press, wns=wns,
                       grid=grid)


def grid_extinction(og_temp, og_grid, mol_of_m, temps_cgs, densities):
    """interpolmolext (extinction.c:534-581; transit_tpu grid.py:341-369):
    per-layer extinction from the grid, differentiable in the layer
    temperatures and the densities (the grid is a constant: no gradient
    flows into it).

    og_temp: (Ntemp,); og_grid: (Nlayer, Ntemp, Nmol, Nwave); mol_of_m:
    (Nmol,) atmosphere molecule index per grid molecule (int64); temps_cgs:
    (n,); densities: (nmolecules, n).  Row i takes the grid's layer i mod
    Nlayer (n = B * Nlayer: forward_batch's pseudo-layers).  Returns (n,
    Nwave)."""
    ntemp = og_temp.shape[0]
    # itemp: index of the grid temperature immediately below temp
    # (binsearchapprox + step-down, extinction.c:562-564):
    it = nearest_index_torch(og_temp, temps_cgs)
    it = torch.where(temps_cgs < og_temp[it], it - 1, it)
    it = it.clamp(0, ntemp - 2)
    t0 = og_temp[it]
    t1 = og_temp[it + 1]
    w0 = (t1 - temps_cgs) / (t1 - t0)
    w1 = (temps_cgs - t0) / (t1 - t0)
    layer = torch.arange(temps_cgs.shape[0],
                         device=temps_cgs.device) % og_grid.shape[0]
    g0 = og_grid[layer, it]                  # (n, Nmol, Nwave)
    g1 = og_grid[layer, it + 1]
    ext = g0 * w0[:, None, None] + g1 * w1[:, None, None]
    dens_m = densities[mol_of_m, :].T        # (n, Nmol)
    return torch.sum(ext * dens_m[:, :, None], dim=1)


# ----------------------------------------------------------------------
# Builders.

@dataclasses.dataclass
class GridCells:
    """The grid's axes and its (layer, temperature) cells, cell-major
    (layer slow, temperature fast: the reference's write order):
    temps (Ntemp,), molID (Nmol,) in output order, press (Nlayer,) cgs,
    and per cell its temperature tt (ncells,), the densities dd
    (nmolecules, ncells) of the layer's abundances at that temperature
    and the partition functions zz (niso, ncells), numpy float64."""
    temps: np.ndarray
    molID: np.ndarray
    press: np.ndarray
    tt: np.ndarray
    dd: np.ndarray
    zz: np.ndarray


def grid_cells(model) -> GridCells:
    """The cells of the model's grid (grid.py:100-141): the temperature
    grid cfg.tlow..thigh by tempdelt, Z splined at its temperatures
    (opacity.c:324-339), molID in output order (opacity.c:349-361), and
    the densities of stateeqnford with the layer's q and mm at the grid
    temperature (opacity.c:392-394)."""
    cfg = model.cfg
    temps = make_temp_sampling(cfg.tlow, cfg.thigh, cfg.tempdelt).v
    ntemp = temps.shape[0]
    atm = model.atm
    nl = atm.nlayers
    Zg = np.stack([splinterp_np(t, z, temps) for t, z in model._pf])
    seen = []
    for mi in model.iso.imol:
        mid = int(model.mol.ids[mi])
        if mid not in seen:
            seen.append(mid)
    press_cgs = atm.press * atm.pfct
    q, mm = atm.q, atm.mm
    dd = np.zeros((len(model.mol.mass), nl * ntemp))
    for r in range(nl):
        dens = (AMU * q[:, r][None, :] * press_cgs[r] / KB /
                temps[:, None])                                  # (T, nm)
        dens = dens * (mm[r] if atm.by_mass
                       else np.asarray(model.mol.mass)[None, :])
        dd[:, r * ntemp:(r + 1) * ntemp] = dens.T
    return GridCells(temps=temps, molID=np.array(seen, dtype=np.int32),
                     press=press_cgs, tt=np.tile(temps.astype(np.float64),
                                                 nl),
                     dd=dd, zz=np.tile(Zg, (1, nl)))


def _finish(model, cells: GridCells, rows: np.ndarray, path) -> OpacityGrid:
    nl, ntemp = model.atm.nlayers, cells.temps.shape[0]
    og = OpacityGrid(molID=cells.molID, temp=cells.temps, press=cells.press,
                     wns=model.wns.v.copy(),
                     grid=rows.reshape(nl, ntemp, rows.shape[1],
                                       rows.shape[2]))
    if path:
        write_opacity_grid(path, og)
    return og


def exact_chunks(model, cells: GridCells, cell_batch: int | None = None):
    """The exact build's chunks of cells: yields (slice of cells, the
    group tables of lbl.layer_groups(nm=Nmol) on them, the per-molecule
    ScatterTables).  ``cell_batch`` defaults to lbl.GROUP_ROW_ENTRIES of
    the model's device over the line (or group) count, and stays below
    the kernels' int32 indices (lbl.chunk_rows)."""
    plan, d = model.plan, model.dev
    nm = model.iso.nmol_out
    ncells = cells.tt.shape[0]
    cell_batch = lbl.chunk_rows(plan, model.device, nm * plan.n_coarse,
                                cell_batch)
    s = lbl.permol_tables(lbl.scatter_tables(plan, d), d["line_iout"],
                          d["g_primary"], nm)
    wn0 = float(model.wns.v[0])
    for c0 in range(0, ncells, cell_batch):
        sl = slice(c0, min(c0 + cell_batch, ncells))
        with torch.no_grad():
            grp = lbl.layer_groups(
                d, model._t(cells.tt[sl]), model._t(cells.dd[:, sl]),
                model._t(cells.zz[:, sl]), model._molm_t, model._molrad_t,
                wn0=wn0, ethresh=model.cfg.ethreshold, nm=nm,
                use_kernel=model.use_kernel)
        yield sl, grp, s


def build_opacity_grid(model, path: str = None,
                       cell_batch: int = None) -> OpacityGrid:
    """calcopacity (opacity.c:281-427; transit_tpu grid.py:83-171):
    per-molecule extinction on the (layer x temperature x molecule x
    wavenumber) grid via exact mode's profile-table extinction (permol),
    all cells as pseudo-layers, ``cell_batch`` of them at a time
    (:func:`exact_chunks`).  The model must be in exact mode; its
    ``use_kernel`` picks the ``profile_scatter`` kernel on the card.
    Written to ``path`` (float64) when given."""
    from transit_tpu_torch.opacities.kernel_profile import \
        profile_scatter_permol

    if model.mode != "exact" or model.plan is None:
        raise ValueError("build_opacity_grid needs an exact-mode model with "
                         "a line list")
    cells = grid_cells(model)
    rows = np.zeros((cells.tt.shape[0], model.iso.nmol_out, model.wns.n))
    for sl, grp, s in exact_chunks(model, cells, cell_batch):
        # Copied in the model's dtype; numpy widens it on assignment.
        rows[sl] = profile_scatter_permol(
            grp, s, use_kernel=model.use_kernel).cpu().numpy()
    return _finish(model, cells, rows, path)


@dataclasses.dataclass
class MoleculePlan:
    """One output molecule's part of the fast build: its banded plan over
    all cells, the plan's tensors and, on the card, its kernel index
    (banded.banded_index)."""
    m: int
    bplan: fast.BandedPlan
    devs: list
    index: dict | None


def fast_plans(model, cells: GridCells) -> list:
    """Per output molecule with lines (grid.py:222-262): the width bounds
    over the cells of that molecule's isotopes only (aL_m, aDf_m) and the
    banded plan (max_bands 4, far-wing shells) of its lines over the
    cells, as :class:`MoleculePlan`."""
    wl, isoid, elow, gf = select_lines(model.tli, model.wns.i, model.wns.f)
    wavn = 1.0 / (np.asarray(wl) * TLI_WAV_UNITS)
    iso, mol = model.iso, model.mol
    tt, dd = cells.tt, cells.dd
    fdop = np.sqrt(2.0 * KB * tt / AMU) * float(SQRTLN2) / LS
    flor = np.sqrt(2.0 * KB * tt / PI / AMU) / (AMU * LS)
    out = []
    for m in range(iso.nmol_out):
        sel = iso.iout[isoid] == m
        if not np.any(sel):
            continue
        aL_m = np.zeros(tt.shape[0])
        aDf_m = np.zeros(tt.shape[0])
        for mi in np.nonzero(iso.iout == m)[0]:
            aDf_m = np.maximum(aDf_m, fdop / np.sqrt(iso.mass[mi]))
            al = np.zeros_like(tt)
            for j in range(len(mol.mass)):
                csd = mol.radius[j] + mol.radius[iso.imol[mi]]
                al += (dd[j] / mol.mass[j] * csd * csd *
                       np.sqrt(1.0 / iso.mass[mi] + 1.0 / mol.mass[j]))
            aL_m = np.maximum(aL_m, flor * al)
        bplan = fast.make_banded_plans(
            wavn[sel], isoid[sel], elow[sel], gf[sel], wn_i=model.wns.i,
            dwn=model.wns.d, n_coarse=model.wns.n, aL_layers=aL_m,
            aDf_layers=aDf_m, wn_max=model.wns.f, nwidth=model.cfg.nwidth,
            max_bands=4, split_far=True)
        devs = fast.banded_device_arrays(bplan, iso, dtype=model.dtype,
                                         device=model.device)
        index = (banded.banded_index(bplan, devs, model.device)
                 if model.device.type == "cuda" else None)
        out.append(MoleculePlan(m=m, bplan=bplan, devs=devs, index=index))
    return out


def fast_tables(model, cells: GridCells, mp: MoleculePlan):
    """(the per-cell tables at unit density with kmax, the cells'
    temperatures, the launches' keywords) of one molecule's plan: the
    widths from the cells' densities, a density of 1, the kmax scan over
    the molecule's lines (banded.prep_layers(unit_density=True);
    fast._prep_layers(unit_density=True), fast.py:338-372)."""
    t = model._t
    temps = t(cells.tt)
    kernel = model.use_kernel and model.device.type == "cuda"
    with torch.no_grad():
        tab = banded.prep_layers(mp.devs[0], temps, t(cells.dd), t(cells.zz),
                                 model._molm_t, model._molrad_t,
                                 use_kernel=kernel, unit_density=True)
    kw = dict(wn_i=model.wns.i, dwn=model.wns.d,
              ethresh=model.cfg.ethreshold, nwidth=model.cfg.nwidth)
    return tab, temps, kw


def fast_rows(model, cells: GridCells, mp: MoleculePlan, stats=None):
    """One molecule's grid rows (ncells, Nwave) in the model's dtype:
    the banded function at unit density over all cells, through the
    kernels on the card (every band's cells in one launch of each of its
    kernels, banded._launch_all) or the plain versions
    (banded.plain_bands).  ``stats``: as banded_kernel_extinction's."""
    tab, temps, kw = fast_tables(model, cells, mp)
    with torch.no_grad():
        if model.use_kernel and model.device.type == "cuda":
            return banded._launch_all(mp.bplan, mp.devs, tab, temps, kw,
                                      False, mp.index, stats or {})
        return banded.plain_bands(mp.bplan, mp.devs, tab, temps, kw)


def build_opacity_grid_fast(model, path: str = None,
                            plans: list = None) -> OpacityGrid:
    """Fast-path (permol) grid build (transit_tpu grid.py:174-338): per
    output molecule a banded plan over all (layer x temperature) cells
    and the on-the-fly Voigt kernels at unit density (:func:`fast_rows`).
    True per-line widths instead of the profile table's quantized ones,
    so the grid differs from the exact build's by that quantization.  The
    model may be in either mode: only its line list and atmosphere are
    read.  ``plans``: :func:`fast_plans` of the model, when made already.
    Written to ``path`` (float64) when given."""
    if model.tli is None:
        raise ValueError("build_opacity_grid_fast needs a model with a line "
                         "list")
    cells = grid_cells(model)
    rows = np.zeros((cells.tt.shape[0], model.iso.nmol_out, model.wns.n))
    for mp in plans if plans is not None else fast_plans(model, cells):
        rows[:, mp.m, :] = fast_rows(model, cells, mp).cpu().numpy()
    return _finish(model, cells, rows, path)
