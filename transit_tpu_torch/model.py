"""TransitModel: the end-to-end spectrum pipeline on tensors.

The counterpart of transit_tpu.model (model.py:65-272, 360-754) on the
path this package ports so far: exact mode (the default, as in JAX: the
reference's profile-table scheme, opacities/lbl.py) and fast mode on the
unbanded or the layer-banded tile plan (``bands``, with far-wing shells),
eclipse and transit geometry, the atmosphere file's radius grid or its
resampling (``raddelt``), static or hydrostatic radii
(gsurf/refpress/refradius), the opacity grid's interpolation mode (a
``cfg.opacityfile`` that exists: the line extinction interpolated from
the grid, opacities/grid.py, no line list read) and the extinction
savefile (``cfg.saveext``, read and written by ``compute`` only).  Init
loads and precomputes everything
static (grids, line plans, the profile table, path-weight matrices,
spline operators); ``forward(temps, q)``, the retrieval step, recomputes
densities, partition functions and, with hydrostatic radii, the radii and
path weights, and runs the spectrum: line extinction through the CUDA
kernels (opacities/kernel_profile.py in exact mode, opacities/kernel_lbl.py
on the unbanded fast plan, opacities/banded.py on the banded one), then
CIA, scattering, clouds, optical depth and the eclipse flux or the
transit modulation in torch ops.  ``forward`` and, in fast mode,
``forward_batch`` (B profiles as B*nl layers of one kernel pass) are
differentiable in T and q: the line extinction's backward runs the
backward kernels, the rest is autograd; ``torch.func`` transforms
``forward`` (the kernels' Functions fold a vmapped batch into layers).

The model runs on ``cuda`` unless the caller passes ``device="cpu"``;
with no card and no ``device`` it raises.  On the CPU the kernels' plain
PyTorch versions take their place.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import os

import numpy as np
import torch

from transit_tpu_torch import grids
from transit_tpu_torch.config import ConfigError, TransitConfig
from transit_tpu_torch.constants import (AMU, KB, NAVOGADRO, SUNRADIUS,
                                         TLI_WAV_UNITS)
from transit_tpu_torch.io.atmosphere import read_atmosphere
from transit_tpu_torch.io.crosssec import read_cross_section
from transit_tpu_torch.io.tli import read_tli, select_lines
from transit_tpu_torch.numerics.spline import (splinterp_np,
                                               spline_eval_torch,
                                               spline_operator_np,
                                               spline_second_derivs_np,
                                               spline_second_derivs_torch)
from transit_tpu_torch.opacities import fast, lbl
from transit_tpu_torch.opacities.grid import (grid_extinction,
                                              read_opacity_grid)
from transit_tpu_torch.opacities.banded import (banded_index,
                                                banded_kernel_extinction,
                                                batched_view)
from transit_tpu_torch.opacities.cia import cs_extinction, precompute_cs
from transit_tpu_torch.opacities.clouds import CloudParams, cloud_extinction
from transit_tpu_torch.opacities.kernel_lbl import (kernel_extinction,
                                                    tiles_index)
from transit_tpu_torch.opacities.lbl import IsoConst
from transit_tpu_torch.opacities.scattering import scattering_extinction
from transit_tpu_torch.opacities.voigt import (build_profile_table,
                                               check_profile_table)
from transit_tpu_torch.rt import geometry as rt_geom
from transit_tpu_torch.rt import tau as rt_tau
from transit_tpu_torch.rt.emission import eclipse_intensities, flux
from transit_tpu_torch.rt.transmission import (
    modulation, modulation_m1, modulation_weight_table,
    modulation_weight_table_torch)
from transit_tpu_torch.utils.savefiles import (load_extinction,
                                               save_extinction)

# forward_batch splits a batch into sub-batches of fewer than INDEX_LIMIT
# (layer, wavenumber) outputs: the kernels index them with int32.
INDEX_LIMIT = 2 ** 31


def resolve_device(device=None) -> torch.device:
    """``device`` as given, else ``cuda``; raises when no card is there
    and the caller did not ask for another device."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("transit_tpu_torch runs on a CUDA device and "
                           "none is available; pass device='cpu' to run "
                           "on the CPU")
    return torch.device("cuda")


@dataclasses.dataclass
class SpectrumResult:
    wns: np.ndarray                    # coarse wavenumber grid (cm-1)
    spectrum: torch.Tensor             # flux (eclipse) or modulation (transit)
    intensity: torch.Tensor = None     # (nangle, nwn), eclipse only
    tau: torch.Tensor = None           # (nwn, nh)
    last: torch.Tensor = None          # (nwn,)
    extinction: torch.Tensor = None    # (nlayer, nwn) line extinction
    cia: torch.Tensor = None           # (nwn, nlayer)
    scatt: torch.Tensor = None         # (nwn, nlayer) scattering extinction
    cloud: torch.Tensor = None         # (nwn, nlayer) cloud extinction
    total: torch.Tensor = None         # (nwn, nlayer) total extinction er


class TransitModel:
    def __init__(self, cfg: TransitConfig, dtype=None, mode: str = "exact",
                 use_kernel: bool = True, device=None, tli=None,
                 bands: int = 0, split_far: bool = True,
                 far_decimate: bool = True, wn_window=None,
                 wn_margin: float = 0.0, table=None):
        """``mode``: "exact", the reference's profile-table scheme with
        the C code's profile table, co-add order and index arithmetic
        (the default, as in transit_tpu), or "fast", on-the-fly Voigt on
        line tiles.
        ``use_kernel`` selects the CUDA kernels (True) or their plain
        PyTorch versions (False) for the line extinction; on the CPU
        both compute the plain versions.  ``tli``: a preloaded TliData
        overriding cfg.linedb's full read.  ``dtype`` defaults to
        float32; the kernels take float32 only.  ``bands`` > 0 (fast
        mode; exact mode ignores it, as JAX does): the layer-banded plan
        with at most that many bands, far-wing shells (``split_far``) and
        their decimation (``far_decimate``), as transit_tpu's
        TransitModel(mode="fast", bands=...).  ``table``: exact mode's
        voigt.ProfileTable, when already built for this configuration
        (its layout is checked against the configuration's grids, nwidth
        and table axes, and a mismatch raises ValueError); else it is
        built on the model's device.  ``wn_window=(b0, b1)``: the model
        covers coarse bins [b0, b1) of the global grid (``wns_global``),
        one process's band of a multi-process run
        (parallel/multihost.py); the grids are sliced from the global
        fill, so band spectra concatenate to the global one, and the
        line selection is widened by ``wn_margin`` (cm-1; clipped to the
        global range) so that the wings of lines outside the window
        reach its edge tiles as in one process (transit_tpu
        model.py:68-112, 191-196).  A grid file is read in the window's
        columns only.

        With a ``cfg.opacityfile`` that exists (and ``justOpacity``
        unset) the model reads the grid (mode c of the reference,
        transit_tpu model.py:158-170): no line list, plan or profile
        table; the line extinction is :func:`grid.grid_extinction` of the
        grid on the device in the model's dtype."""
        from transit_tpu_torch.config import validate
        self.cfg = cfg = validate(cfg)
        if mode not in ("exact", "fast"):
            raise ValueError(f"unknown mode {mode!r}")
        if cfg.solution not in ("eclipse", "transit"):
            raise ValueError(f"unknown solution {cfg.solution!r}")
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # The tau product must run in full float32, not TF32 (this
            # sets PyTorch's process-wide switch; its default is False):
            torch.backends.cuda.matmul.allow_tf32 = False
        self.mode = mode
        self.use_kernel = use_kernel
        self.dtype = torch.float32 if dtype is None else dtype

        # --- wavenumber grids (transit.c:44 makewnsample) ---
        self.wns, self.owns = grids.make_wn_sampling(
            wnlow=cfg.wnlow, wnhigh=cfg.wnhigh, wllow=cfg.wllow,
            wlhigh=cfg.wlhigh, wndelt=cfg.wndelt, wnosamp=cfg.wnosamp,
            wnfct=(cfg.wnfct if cfg.wnfct > 0 else 1.0), wlfct=cfg.wlfct)
        self.wns_global = self.wns
        self.wn_window = wn_window
        if wn_window is not None:
            b0, b1 = wn_window
            if not 0 <= b0 < b1 <= self.wns.n:
                raise ValueError(f"wn_window {wn_window} outside the "
                                 f"global grid of {self.wns.n} bins")
            v, o, ov = self.wns.v, self.owns.o, self.owns.v
            self.wns = grids.Sampling(
                i=float(v[b0]), f=float(v[b1 - 1]), d=self.wns.d, o=1,
                v=v[b0:b1].copy(), fct=self.wns.fct)
            self.owns = grids.Sampling(
                i=float(ov[b0 * o]), f=float(ov[(b1 - 1) * o]),
                d=self.owns.d, o=o, v=ov[b0 * o:(b1 - 1) * o + 1].copy(),
                fct=self.owns.fct)

        # --- atmosphere (transit.c:49 getatm) ---
        qmol = cfg.qmol.split(",") if cfg.qmol else None
        qscale = ([float(x) for x in cfg.qscale.split(",")]
                  if cfg.qscale else None)
        self.atm, self.mol = read_atmosphere(cfg.atm, cfg.molfile,
                                             qmol=qmol, qscale=qscale,
                                             allowq=cfg.allowq)
        # Radius sampling: the atmosphere grid (makesample.c:472-482,
        # raddelt = -1), or, for a positive raddelt, an equidistant grid
        # with every atmospheric quantity splined onto it
        # (makesample.c:483-531):
        self.rfct = cfg.radfct if cfg.radfct > 0 else self.atm.rfct
        self._atm0 = None
        if cfg.raddelt == -1.0:
            self.rads_v = self.atm.radius
        else:
            if self.hydrostatic:
                raise ConfigError(
                    "raddelt > 0 combined with hydrostatic retrieval "
                    "(gsurf/refpress/refradius) is not supported: the "
                    "radius grid would change every step while the "
                    "resampling target is fixed.  Use raddelt -1 (keep "
                    "the atmosphere grid, the reference's default).")
            ini = cfg.radlow if cfg.radlow > 0 else self.atm.radius[0]
            fin = cfg.radhigh if cfg.radhigh > 0 else self.atm.radius[-1]
            rs = grids.make_sampling(ini, fin, cfg.raddelt)
            a = self.atm
            old = a.radius
            # The file's layers, on which forward() takes T and q
            # (reloadatm, readatm.c:722-784, re-splined onto the radius
            # grid as makeradsample does, makesample.c:483-531):
            self._atm0 = {"radius": old.copy(), "press": a.press.copy()}
            a.temp = splinterp_np(old, a.temp, rs.v)
            a.press = splinterp_np(old, a.press, rs.v)
            a.mm = splinterp_np(old, a.mm, rs.v)
            a.q = np.stack([splinterp_np(old, qi, rs.v) for qi in a.q])
            a.d = np.stack([splinterp_np(old, di, rs.v) for di in a.d])
            a.radius = rs.v
            self.rads_v = rs.v
        self.ips_v = self.rads_v[::-1].copy()

        # --- opacity grid (transit.c:58 opacity; mode c: the file
        #     exists) ---
        self.ogrid = None
        self.grid_mol_idx = None
        if cfg.opacityfile and os.path.exists(cfg.opacityfile) and \
                not cfg.justOpacity:
            self.ogrid = read_opacity_grid(cfg.opacityfile,
                                           wn_window=wn_window)
            shape = self.ogrid.grid.shape
            if (shape[0], shape[3]) != (self.atm.nlayers, self.wns.n):
                raise ValueError(
                    f"opacity grid {cfg.opacityfile} has {shape[0]} layers "
                    f"x {shape[3]} wavenumbers, the model {self.atm.nlayers}"
                    f" x {self.wns.n}")
            ids = list(self.mol.ids)
            self.grid_mol_idx = np.array(
                [ids.index(int(m)) for m in self.ogrid.molID],
                dtype=np.int32)

        # --- line list (transit.c:52 readlineinfo; skipped when an
        #     opacity grid is present, readlineinfo.c:586-603) ---
        self.tli = tli if tli is not None else (
            read_tli(cfg.linedb) if cfg.linedb and self.ogrid is None
            else None)
        self._setup_isotopes()

        # --- line plans / profile table ---
        self.table = None
        self.plan = None
        self.dev = None
        self.fplan = None
        self.fdev = None
        self.bplan = None
        self.bdev = None
        self.bindex = None
        self.findex = None
        if self.tli is not None:
            # A band model widens the selection by wn_margin (clipped to
            # the global range):
            wl, isoid, elow, gf = select_lines(
                self.tli, max(self.wns_global.i, self.wns.i - wn_margin),
                min(self.wns_global.f, self.wns.f + wn_margin))
            wavn = 1.0 / (np.asarray(wl) * TLI_WAV_UNITS)
            if mode == "exact":
                spec = dict(dwn=self.wns.d / self.owns.o,
                            nwave=self.owns.n, nwidth=cfg.nwidth,
                            ndop=cfg.ndop, nlor=cfg.nlor, dmin=cfg.dmin,
                            dmax=cfg.dmax, lmin=cfg.lmin, lmax=cfg.lmax)
                if table is None:
                    table = build_profile_table(**spec, device=self.device)
                else:
                    check_profile_table(table, **spec)
                self.table = table
                self.plan = lbl.plan_lines(
                    wl, isoid, elow, gf, TLI_WAV_UNITS, wn_i=self.wns.i,
                    odwn=self.owns.d / self.owns.o,
                    dwn=self.wns.d / self.wns.o, owns_v=self.owns.v,
                    n_coarse=self.wns.n, ofactor=self.owns.o)
                self.dev = lbl.device_arrays(self.plan, self.iso, self.table,
                                             dtype=self.dtype,
                                             device=self.device)
            elif bands > 0:
                aL, aDf = fast.layer_width_bounds(
                    self.atm, self.mol, self.iso.mass, self.iso.imol)
                self.bplan = fast.make_banded_plans(
                    wavn, isoid, elow, gf, wn_i=self.wns.i,
                    dwn=self.wns.d, n_coarse=self.wns.n, aL_layers=aL,
                    aDf_layers=aDf, wn_max=self.wns.f, nwidth=cfg.nwidth,
                    max_bands=bands, split_far=split_far,
                    far_decimate=far_decimate)
                self.bdev = fast.banded_device_arrays(
                    self.bplan, self.iso, dtype=self.dtype,
                    device=self.device)
                if self.device.type == "cuda":
                    self.bindex = banded_index(self.bplan, self.bdev,
                                               self.device)
            else:
                mw = fast.max_width_bound(self.atm, self.mol, self.iso.mass,
                                          self.wns.f, self.iso.imol)
                self.fplan = fast.make_fast_plan(
                    wavn, isoid, elow, gf, wn_i=self.wns.i, dwn=self.wns.d,
                    n_coarse=self.wns.n, max_width=mw, nwidth=cfg.nwidth)
                self.fdev = fast.fast_device_arrays(self.fplan, self.iso,
                                                    dtype=self.dtype,
                                                    device=self.device)
                if self.device.type == "cuda":
                    self.findex = tiles_index(self.fplan, self.fdev)

        # --- cross sections (transit.c:63 readcs) ---
        self.cs_tables = []
        self.cs_species = []
        if cfg.csfile:
            for f in cfg.csfile.split(","):
                tb = read_cross_section(f.strip())
                self.cs_tables.append(tb)
                self.cs_species.append(
                    np.array([self.atm.species.index(s)
                              for s in tb.species]))
        self.cs_pre = precompute_cs(self.cs_tables, dtype=self.dtype,
                                    device=self.device)

        # --- geometry / path weights (static radii) ---
        self.solution = cfg.solution
        self.angles = cfg.raygrid_list()
        if self.solution == "eclipse":
            self.W = rt_tau.eclipse_weights(self.rads_v)
            self.Wmod = None
        else:
            self.W = rt_tau.transit_weights(self.rads_v, self.ips_v)
            self.Wmod = modulation_weight_table(self.ips_v[::-1] * self.rfct)

        self._scatter_flag, self._scatter_logext = self._parse_scattering()
        self._cloud = self._parse_cloud()

        # Partition-function spline coefficients (static; evaluated at the
        # layer temperatures per step):
        self._setup_partition()
        self.Z_layers = np.stack(
            [splinterp_np(t, z, self.atm.temp)
             for t, z in self._pf]) if self._pf else np.zeros(
                 (0, self.atm.nlayers))

        # Static tensors the step reads:
        t = self._t
        self._W_t = t(self.W)
        self._Wmod_t = None if self.Wmod is None else t(self.Wmod)
        self._radii_t = t(self.rads_v)
        self._press_t = t(self.atm.press)
        self._press_cgs_t = t(self.atm.press * self.atm.pfct)
        self._molm_t = t(self.mol.mass)
        self._molrad_t = t(self.mol.radius)
        self._molpol_t = t(self.mol.pol)
        self._wns_t = t(self.wns.v)
        self._wns_cgs_t = t(self.wns.v * self.wns.fct)
        self._pf_t = [(t(tt), t(z), t(z2))
                      for (tt, z), z2 in zip(self._pf, self._pf_z2)]
        if self.ogrid is not None:
            # A copy: the file's memmap is read-only.
            self._ogrid_t = torch.tensor(self.ogrid.grid, dtype=self.dtype,
                                         device=self.device)
            self._ogrid_temp_t = t(self.ogrid.temp)
            self._grid_mol_t = torch.as_tensor(
                self.grid_mol_idx.astype(np.int64), device=self.device)
        if self._atm0 is not None:
            r0 = self._atm0["radius"]
            self._r0_t = t(r0)
            self._r0_op_t = t(spline_operator_np(r0))
            self._press0_cgs_t = t(self._atm0["press"] * self.atm.pfct)

    @property
    def hydrostatic(self) -> bool:
        """Radii from hydrostatic balance at every step (gsurf, refpress
        and refradius all set), as transit_tpu's forward decides."""
        cfg = self.cfg
        return bool(cfg.gsurf and cfg.refpress and cfg.refradius)

    def _t(self, a):
        """Host array -> tensor in the model's dtype and device."""
        return torch.as_tensor(np.asarray(a, dtype=np.float64),
                               dtype=self.dtype, device=self.device)

    # ------------------------------------------------------------------
    def _setup_isotopes(self):
        """Cumulative isotope constants (readlineinfo.c:134-244, setimol
        readlineinfo.c:249-278, and calcopacity's molID ordering
        opacity.c:349-361)."""
        if self.tli is None:
            self.iso = IsoConst(mass=np.zeros(0), ratio=np.zeros(0),
                                imol=np.zeros(0, np.int32),
                                iout=np.zeros(0, np.int32), nmol_out=0)
            return
        names, masses, ratios, dbidx, mols = self.tli.iso_index()
        imol = np.array([self.atm.species.index(m) for m in mols],
                        dtype=np.int32)
        iout = np.zeros(len(names), dtype=np.int32)
        seen = []
        for i, mi in enumerate(imol):
            mid = self.mol.ids[mi]
            if mid not in seen:
                seen.append(mid)
            iout[i] = seen.index(mid)
        self.iso = IsoConst(mass=masses, ratio=ratios, imol=imol,
                            iout=iout, nmol_out=len(seen))
        self.iso_names = names

    def _setup_partition(self):
        """(temps, z) pairs per isotope plus static spline coefficients
        (makesample.c:533-543)."""
        self._pf = []
        self._pf_z2 = []
        if self.tli is None:
            return
        for db in self.tli.databases:
            for iso in db.isotopes:
                self._pf.append((db.temps, iso.partition))
                self._pf_z2.append(spline_second_derivs_np(db.temps,
                                                           iso.partition))

    def partition(self, temps_raw: torch.Tensor) -> torch.Tensor:
        """Z (niso, nl) at the layer temperatures (natural spline; the
        reference evaluates at unscaled atmosphere temperatures)."""
        if not self._pf_t:
            return torch.zeros((0, temps_raw.shape[0]), dtype=self.dtype,
                               device=self.device)
        return torch.stack([spline_eval_torch(t, z, z2, temps_raw)
                            for t, z, z2 in self._pf_t])

    def _parse_scattering(self):
        s = self.cfg.scattering
        if s is None:
            return 0, 0.0
        if s.strip() == "polar":
            return 2, 0.0
        return 1, float(s)

    def _parse_cloud(self):
        """argum.c:636-718: 'type,ext,top,bot[,extra...]' with type one of
        ext/opa/B17/F18/P19 (reference syntax) or the numeric flag 1-5."""
        c = self.cfg.cloud
        if c is None:
            if self.cfg.cloudtop is not None:
                # Standalone --cloudtop (argum.c CLA_CLOUDTOP, 720-726):
                # an opaque constant-extinction deck from cloudtop down
                # 10 dex, cloudext = 100:
                return CloudParams(flag=1, cloudext=100.0,
                                   cloudtop=self.cfg.cloudtop,
                                   cloudbot=self.cfg.cloudtop + 10.0)
            return CloudParams()
        names = {"ext": 1, "opa": 2, "B17": 3, "F18": 4, "P19": 5}
        head, *rest = c.split(",")
        flag = names.get(head.strip(), None)
        if flag is None:
            flag = int(float(head))
        parts = [float(flag)] + [float(x) for x in rest]
        p = CloudParams(flag=flag, cloudext=parts[1], cloudtop=parts[2],
                        cloudbot=parts[3])
        extra = parts[4:]
        if flag == 3 and extra:
            p.gamma = extra[0]
        elif flag == 4 and len(extra) >= 3:
            p.gamma, p.Q, p.r = extra[0], extra[1], extra[2]
        elif flag == 5 and len(extra) >= 3:
            p.gamma, p.sig, p.refwn = extra[0], extra[1], extra[2]
        return p

    # ------------------------------------------------------------------
    def device_tree(self):
        """The (potentially large) tensors the spectrum step reads: the
        opacity grid in grid mode; exact mode's line, group and
        profile-table tensors (lbl.device_arrays), or the line tile
        tensors and isotope tables, per band on the banded plan."""
        if self.ogrid is not None:
            return self._ogrid_t
        if self.mode == "exact":
            return self.dev
        return self.bdev if self.bplan is not None else self.fdev

    def make_forward(self):
        """The compiled step, ``(T, q) -> spectrum``, with the tensors of
        :meth:`device_tree` bound (transit_tpu model.py:374-379, a
        jax.jit of ``forward``).  On a card the step runs as CUDA graph
        replays (step_graph.GraphedStep): each signature (shapes and
        dtypes of T and q, and which of them requires grad under grad
        mode) is captured once after warm-up calls; with a gradient the
        captured backward replays too, so that ``torch.autograd.grad(
        fwd(T, q).sum(), (T, q))`` works as jax.grad over JAX's
        ``make_forward``; T (B, nl) with q (B, nmol, nl) runs the batched
        step (:meth:`forward_batch`, graphed per B), the counterpart of
        jax.vmap over the jitted step.  A capture that fails raises; the
        callable never falls back to eager calls.  Every call returns a
        tensor of its own and copies of the gradients; a call's gradient
        is taken before the next call of its signature.  On a CPU model
        it is the eager ``forward`` (``forward_batch`` for a 2-D T)
        bound to :meth:`device_tree`.

        Retrieval loops (Adam, HMC through
        retrieval.batched_value_and_grad) call it in place of
        ``forward``.  The settings the step reads as Python values
        (:meth:`set_radius`, :meth:`set_cloudtop`, :meth:`set_scattering`
        and the cfg's fields) are fixed when ``make_forward()`` is
        called, as JAX's trace fixes them; a new ``make_forward()`` sees
        new values.  The model's tensors must not be replaced while a
        callable lives: its graphs hold their addresses."""
        settings, dev = self._settings(), self.device_tree()

        def step(temps_raw, q):
            return self._step(temps_raw, q, settings, dev)
        if self.device.type == "cuda":
            from transit_tpu_torch.step_graph import GraphedStep
            return GraphedStep(step, self.dtype, self.device, "make_forward")
        return step

    def _step(self, temps_raw, q, settings: tuple, dev):
        """The step of :meth:`make_forward` with ``settings``
        (:meth:`_settings`) and the tensors ``dev``: :meth:`forward` for
        T (nl,); for T (B, nl) :meth:`forward_batch` (fast mode, raddelt
        -1), else torch.func.vmap of :meth:`forward`."""
        temps_raw = torch.as_tensor(temps_raw, dtype=self.dtype,
                                    device=self.device)
        q = torch.as_tensor(q, dtype=self.dtype, device=self.device)
        with self._with_settings(settings):
            if temps_raw.dim() == 1:
                return self.forward(temps_raw, q, dev=dev)
            if self.mode == "fast" and self._atm0 is None:
                return self.forward_batch(temps_raw, q, dev=dev)
            return torch.func.vmap(lambda t, qq: self.forward(
                t, qq, dev=dev))(temps_raw, q)

    def _settings(self) -> tuple:
        """Copies of the settings the step reads as Python values: the
        configuration, the cloud deck and the scattering parameters."""
        return (copy.copy(self.cfg), copy.copy(self._cloud),
                self._scatter_flag, self._scatter_logext)

    @contextlib.contextmanager
    def _with_settings(self, settings: tuple):
        """The model with ``settings`` (:meth:`_settings`) in place of its
        own, which are restored on exit."""
        own = (self.cfg, self._cloud, self._scatter_flag,
               self._scatter_logext)
        (self.cfg, self._cloud, self._scatter_flag,
         self._scatter_logext) = settings
        try:
            yield
        finally:
            (self.cfg, self._cloud, self._scatter_flag,
             self._scatter_logext) = own

    def line_extinction(self, temps_cgs, densities, Z, dev=None,
                        batch: int = 1, kmax_override=None):
        """Per-layer line extinction (nlayer, nwn), differentiable in the
        temperatures, densities and Z: in exact mode lbl.layer_extinction
        (in chunks of layers, lbl.chunk_rows: kernel_profile.ProfileScatter
        for one chunk, ChunkedExtinction for more), in fast mode
        kernel_lbl.LineExtinction; the backward kernels on the card, the
        plain VJPs on the CPU or with ``use_kernel=False``.  ``dev``
        overrides the model's stored tensors (device_tree).  ``batch``:
        the layers are ``batch`` profiles' layers one after another
        (forward_batch), and the banded plan is its batched view
        (:meth:`_batched_bplan`).  ``kmax_override``: an external
        per-layer kmax (nl,), a constant, in place of the scan over the
        model's lines (the multi-process bands' global kmax; fast mode).
        In grid mode: grid.grid_extinction (differentiable in the
        temperatures and densities; ``dev`` overrides the grid)."""
        nl = temps_cgs.shape[0]
        if self.ogrid is not None:
            return grid_extinction(self._ogrid_temp_t,
                                   dev if dev is not None else self._ogrid_t,
                                   self._grid_mol_t, temps_cgs, densities)
        args = (temps_cgs, densities, Z, self._molm_t, self._molrad_t)
        if self.mode == "exact":
            if self.plan is None or self.plan.n_lines == 0:
                return torch.zeros((nl, self.wns.n), dtype=self.dtype,
                                   device=self.device)
            return lbl.layer_extinction(
                self.plan, dev if dev is not None else self.dev, *args,
                wn0=float(self.wns.v[0]), ethresh=self.cfg.ethreshold,
                use_kernel=self.use_kernel)
        kw = dict(wn_i=self.wns.i, dwn=self.wns.d,
                  ethresh=self.cfg.ethreshold, nwidth=self.cfg.nwidth)
        if self.bplan is not None:
            bdev = dev if dev is not None else self.bdev
            bplan, index = (self.bplan, self.bindex) if batch == 1 else \
                self._batched_bplan(batch)
            # The index packs the stored tensors' shell lines.
            return banded_kernel_extinction(
                bplan, bdev, *args, index=index if bdev is self.bdev else
                None, use_kernel=self.use_kernel,
                kmax_override=kmax_override, **kw)
        if self.fplan is None:
            return torch.zeros((nl, self.wns.n), dtype=self.dtype,
                               device=self.device)
        fdev = dev if dev is not None else self.fdev
        return kernel_extinction(self.fplan, fdev, *args,
                                 use_kernel=self.use_kernel,
                                 kmax_override=kmax_override,
                                 index=self.findex if fdev is self.fdev
                                 else None, **kw)

    # ------------------------------------------------------------------
    def _spectrum(self, temps_raw, q, densities, full_result: bool,
                  dev=None, geom=()):
        """Shared spectrum core; ``geom``: (radii, W, Wmod) of the step,
        or () for the static geometry."""
        temps_cgs = temps_raw * self.atm.tfct
        Z = self.partition(temps_raw)
        ex = self.line_extinction(temps_cgs, densities, Z, dev=dev)
        return self._assemble(temps_raw, q, densities, ex, full_result,
                              *geom)

    def _assemble(self, temps_raw, q, densities, ex, full_result: bool,
                  radii=None, W=None, Wmod=None, wn=None):
        """Everything downstream of the line extinction: scattering,
        clouds, CIA, optical depth, and the eclipse flux or the transit
        modulation (transit_tpu model.py:456-531).  radii, W and Wmod
        (transit only) are the step's geometry (:meth:`geometry`); None
        takes the static one.  ``wn``: the (raw, cgs) wavenumber tensors
        of the columns of ``ex`` (a shard's, parallel/sharded.py); None
        takes the model's grid."""
        if W is None:
            radii, W, Wmod = self._radii_t, self._W_t, self._Wmod_t
        wns_raw, wns_cgs = (self._wns_t, self._wns_cgs_t) if wn is None \
            else wn
        atm = self.atm
        nl = atm.nlayers
        temps_cgs = temps_raw * atm.tfct
        # The reference feeds computeextscat the *raw* (file-unit) pressure
        # and temperature arrays (tau.c:113-114,226), not cgs:
        e_s = scattering_extinction(
            self._scatter_flag, self._scatter_logext, self._press_t,
            temps_raw, wns_cgs, densities, self._molm_t, self._molpol_t)

        # Mean mass density and H2 number density for cloud models
        # (tau.c:193-213; the reference leaves mean_dens uninitialized —
        # we compute the intended quantity):
        molm = self._molm_t
        mean_molar = torch.sum(densities / molm[:, None] * q, dim=0)
        mean_mm = torch.sum(molm[:, None] * q, dim=0)
        mean_dens = mean_molar * mean_mm
        iH2 = (atm.species.index("H2") if "H2" in atm.species else -1)
        nH = (densities[iH2] / molm[iH2] * q[iH2] * NAVOGADRO if iH2 >= 0
              else torch.zeros(nl, dtype=self.dtype, device=self.device))
        e_c = cloud_extinction(self._cloud, self._press_t, mean_dens, nH,
                               wns_cgs)

        e_cs = (cs_extinction(self.cs_tables, self.cs_pre, wns_raw,
                              temps_cgs, densities, molm, self.cs_species)
                if self.cs_tables else
                torch.zeros((wns_raw.shape[0], nl), dtype=self.dtype,
                            device=self.device))

        er = ex.T + e_s + e_c + e_cs            # (nwn, nl)
        tau = rt_tau.optical_depth(er, W, self.rfct)
        last = rt_tau.last_index(tau, self.cfg.toomuch)

        intens = None
        if self.solution == "eclipse":
            intens = eclipse_intensities(tau, last, wns_cgs,
                                         temps_cgs.flip(0), self.angles)
            spec = flux(intens, self.angles)
        else:
            cfg = self.cfg
            srad = cfg.starrad * SUNRADIUS
            ips = radii.flip(0)
            if cfg.modlevel == -1:
                spec = modulation_m1(tau, last, ips, self.rfct, srad,
                                     cfg.toomuch)
            else:
                spec = modulation(tau, last, ips, self.rfct, srad,
                                  cfg.toomuch, transparent=cfg.transparent,
                                  Wmod=Wmod)
        if not full_result:
            return spec
        return SpectrumResult(wns=self.wns.v, spectrum=spec,
                              intensity=intens, tau=tau, last=last,
                              extinction=ex, cia=e_cs,
                              scatt=e_s.expand(er.shape),
                              cloud=e_c.expand(er.shape), total=er)

    def mean_mass(self, q):
        """Mean molecular mass (..., nl) of abundances (..., nmol, nl)
        (checkaddmm, readatm.c:122-159)."""
        molm = self._molm_t[:, None]
        if self.atm.by_mass:
            return 1.0 / torch.sum(q / molm, dim=-2)
        return torch.sum(q * molm, dim=-2)

    def geometry(self, temps_raw, q):
        """(radii, W, Wmod) of a step for T (..., nl) and q (..., nmol,
        nl): with hydrostatic radii rebuilt from T and the mean molecular
        mass (radpress, then the path weights and, for transit, the
        modulation table; transit_tpu model.py:737-751), batched over the
        leading dimensions; otherwise () (the static geometry).

        The path weights are built in float64 from the radii and cast to
        the model's dtype, as the static path's numpy weights are (JAX
        builds them in the model's dtype): in float32 the tangent-point
        terms (r^2 - r0^2 of radii ~300 times their spacing, the
        parabola's cancelling powers of r/dr) make the gradient in T
        move by ~5e-2 of its max under a 1e-6 relative change of the
        extinction, by ~3e-7 when they are built in float64
        (tests/test_torch_transit_precision.py)."""
        if not self.hydrostatic:
            return ()
        cfg = self.cfg
        radii = rt_geom.radpress_torch(cfg.gsurf, cfg.refpress,
                                       cfg.refradius, temps_raw,
                                       self.mean_mass(q), self.atm.press,
                                       self.rfct)
        weights = (rt_geom.eclipse_weights_torch if self.solution ==
                   "eclipse" else rt_geom.transit_weights_torch)
        W = weights(radii.double()).to(self.dtype)
        if self.solution == "eclipse":
            return radii, W, None
        return radii, W, modulation_weight_table_torch(radii * self.rfct)

    # ------------------------------------------------------------------
    # The reference's re-entrant interface (transit.c:98-115
    # set_radius/set_cloudtop/set_scattering):
    def set_radius(self, refradius: float):
        """Set the reference ('surface') radius for hydrostatic solves."""
        self.cfg.refradius = refradius

    def set_cloudtop(self, cloudtop: float):
        """Set the cloud-deck top pressure (log10 of the pressure in the
        atmosphere file's units)."""
        self._cloud.cloudtop = cloudtop

    def set_scattering(self, logext: float):
        """Set the Lecavelier H2-Rayleigh log-extinction parameter."""
        self._scatter_flag = 1
        self._scatter_logext = logext

    # ------------------------------------------------------------------
    def compute(self):
        """Spectrum for the file atmosphere (static radii).  With
        ``cfg.saveext`` the line extinction is restored from that file
        when it holds one of this model's shape, and written there when it
        does not (tau.c:155-156, extinction.c:62-137; transit_tpu
        model.py:674-691).  Only ``compute`` reads it: ``forward`` takes
        new profiles, and a restored extinction would cut its gradient
        through the line term (transit_tpu model.py:387-402)."""
        atm = self.atm
        T, q, dens = self._t(atm.temp), self._t(atm.q), self._t(atm.d)
        saved = (load_extinction(self.cfg.saveext, atm.nlayers, self.wns.n)
                 if self.cfg.saveext else None)
        if saved is not None:
            return self._assemble(T, q, dens, self._t(saved[0]),
                                  full_result=True)
        res = self._spectrum(T, q, dens, full_result=True)
        if self.cfg.saveext:
            save_extinction(self.cfg.saveext,
                            res.extinction.detach().double().cpu().numpy())
        return res

    def _profiles(self, temps_raw, q):
        """T and q as tensors of the model (a tensor that requires grad
        stays in its graph: as_tensor converts it with a differentiable
        copy, or returns it as it is) and the ideal-gas densities, for
        (..., nl) T and (..., nmol, nl) q (reloadatm, readatm.c:722-784).
        With raddelt > 0, T and q come on the atmosphere file's layers:
        the densities are computed there, then T, q and the densities
        are splined onto the radius grid (makesample.c:483-531;
        transit_tpu model.py:714-729)."""
        atm = self.atm
        temps_raw = torch.as_tensor(temps_raw, dtype=self.dtype,
                                    device=self.device)
        q = torch.as_tensor(q, dtype=self.dtype, device=self.device)
        molm = self._molm_t[:, None]
        mm = self.mean_mass(q)
        press = self._press_cgs_t if self._atm0 is None else \
            self._press0_cgs_t
        rho = AMU * q * press / KB / (temps_raw * atm.tfct)[..., None, :]
        densities = rho * (mm[..., None, :] if atm.by_mass else molm)
        if self._atm0 is not None:
            # One spline pass over the columns [T, q..., densities...]
            # on the static abscissae r0:
            nm = q.shape[-2]
            Y = torch.cat([temps_raw[None], q, densities]).T  # (nl0, 1+2nm)
            z = spline_second_derivs_torch(self._r0_t, Y, self._r0_op_t)
            out = spline_eval_torch(self._r0_t, Y, z, self._radii_t).T
            temps_raw, q, densities = out[0], out[1:1 + nm], out[1 + nm:]
        return temps_raw, q, densities

    def forward(self, temps_raw, q, dev=None):
        """Retrieval step: new T (nl,) / q (nmol, nl) profiles ->
        spectrum (nwn,), differentiable in T and q
        (``torch.autograd.grad(model.forward(T, q).sum(), (T, q))``).

        Reproduces reloadatm (readatm.c:722-784): mean molecular mass,
        ideal-gas densities, hydrostatic radii and their path weights
        when gsurf/refpress/refradius are set (:meth:`geometry`), then
        the full spectrum.  With raddelt > 0, T and q are on the
        atmosphere file's layers (:meth:`_profiles`).  ``dev`` optionally
        supplies the line tile tensors (see device_tree)."""
        temps_raw, q, densities = self._profiles(temps_raw, q)
        return self._spectrum(temps_raw, q, densities, full_result=False,
                              dev=dev, geom=self.geometry(temps_raw, q))

    def run_transit(self, flat_input):
        """The reference's retrieval entry point (transit.c:118-122
        run_transit via SWIG, transit.i:103; transit_tpu model.py:643):
        one flat array [T_0..T_nl-1, q_mol0_0.., ..., q_molN_..] of
        length nlayers*(nmol+1) -> spectrum; differentiable like
        :meth:`forward`."""
        nl = (len(self._atm0["radius"]) if self._atm0 is not None
              else self.atm.nlayers)
        nmol = len(self.atm.species)
        flat = torch.as_tensor(flat_input, dtype=self.dtype,
                               device=self.device)
        return self.forward(flat[:nl], flat[nl:nl * (nmol + 1)].reshape(
            nmol, nl))

    def _batched_bplan(self, B: int):
        """The batched view of the banded plan for forward_batch, and its
        kernel index (banded.batched_view), cached per B."""
        cache = self.__dict__.setdefault("_bplan_batch_cache", {})
        if B not in cache:
            cache[B] = batched_view(self.bplan, self.bindex, B)
        return cache[B]

    def forward_batch(self, temps_raw, q, dev=None):
        """Batched retrieval step: (B, nl) temperatures x (B, nmol, nl)
        abundances -> (B, nwn) spectra, differentiable in both
        (transit_tpu model.py:557-640).

        The line extinction takes the batch as extra layers: one pass of
        the kernels (forward and backward) over B*nl pseudo-layers
        through the same tile plans (the function is independent per
        layer); the spectrum assembly (scattering, clouds, CIA, tau,
        eclipse or transit) is torch.func.vmap over ``_assemble``, as JAX
        vmaps it.  With hydrostatic radii every member's radii, W and
        Wmod are built in one batched :meth:`geometry` call outside the
        vmap and enter it as inputs.  In grid mode the line extinction
        interpolates the grid for the B*nl pseudo-layers (each its
        layer's rows; JAX's forward_batch has no grid branch and leaves
        the line term out there).  A batch of B*nl*nwn >= INDEX_LIMIT
        outputs (the kernels' int32 indices) runs as consecutive
        sub-batches below it (:meth:`batch_splits`).  Requires
        mode="fast" and raddelt -1 (torch.func.vmap(model.forward) covers
        the others)."""
        if self.mode != "fast" or self._atm0 is not None:
            raise ValueError("forward_batch requires mode='fast' and "
                             "raddelt -1; use torch.func.vmap(model.forward)")
        splits = self.batch_splits(temps_raw.shape[0])
        if len(splits) == 1:
            return self._forward_batch(temps_raw, q, dev)
        return torch.cat([self._forward_batch(temps_raw[a:b], q[a:b], dev)
                          for a, b in splits])

    def batch_splits(self, B: int) -> list:
        """[(start, stop)] of forward_batch's sub-batches: as few as keep
        each one's (layer, wavenumber) outputs below INDEX_LIMIT, of
        nearly equal size; raises when one member alone reaches it."""
        per = self.atm.nlayers * self.wns.n
        most = (INDEX_LIMIT - 1) // per
        if most < 1:
            raise ValueError(f"forward_batch: {self.atm.nlayers} layers x "
                             f"{self.wns.n} wavenumbers pass the kernels' "
                             f"int32 indices")
        n = max(1, -(-B // most))
        edges = [B * i // n for i in range(n + 1)]
        return list(zip(edges[:-1], edges[1:]))

    def _forward_batch(self, temps_raw, q, dev=None):
        """One pass of :meth:`forward_batch` over a batch below the
        kernels' index limit."""
        B, nl = temps_raw.shape
        temps_raw, q, densities = self._profiles(temps_raw, q)
        nm = densities.shape[1]
        ex = self.line_extinction(
            (temps_raw * self.atm.tfct).reshape(B * nl),
            densities.movedim(1, 0).reshape(nm, B * nl),
            self.partition(temps_raw.reshape(B * nl)), dev=dev, batch=B)
        ex = ex.reshape(B, nl, self.wns.n)
        radii, W, Wmod = self.geometry(temps_raw, q) or (None,) * 3
        g = None if W is None else 0
        return torch.func.vmap(
            lambda t, qq, dd, e, r, w, wm: self._assemble(
                t, qq, dd, e, False, r, w, wm),
            in_dims=(0, 0, 0, 0, g, g, None if Wmod is None else 0))(
                temps_raw, q, densities, ex, radii, W, Wmod)
