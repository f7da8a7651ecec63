"""Multi-process execution: per-process wavenumber bands — the
counterpart of transit_tpu.parallel.multihost.

The coarse wavenumber axis is split into contiguous per-process bands;
each process

  * loads only its band's lines from the TLI (io.tli.read_tli_band, the
    memmap binary search that stands for readdatarng's in-file search,
    readlineinfo.c:416-537), with a wing margin so that the wings of
    lines outside the band reach its edge tiles;
  * builds band-local tile plans (``TransitModel(wn_window=...,
    wn_margin=...)``) and runs the sharded step (parallel/sharded.py)
    on its card, compiled there as CUDA graph replays, as is the band's
    kmax;
  * joins small host-tensor collectives on a gloo group: an all-reduce
    MAX of the (nlayer,) kmax (so the ethresh cut is the one of a
    single-process run, extinction.c:400-427, 467-470), a padded
    all-gather of the band spectra, and, for a gradient, one all-reduce
    SUM of [loss, dT, dq] outside autograd.

Host tensors over gloo let any number of processes share one card (NCCL
refuses two ranks on one GPU) and keep the collectives out of the
kernels' stream.  Bands are line-count balanced (:func:`balanced_blocks`):
per-band work follows the number of lines, whose density varies widely
across the spectrum.

The process count and index are ``torch.distributed``'s world size and
rank, 1 and 0 when it is not initialised (then this is the band machinery
without collectives).
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from transit_tpu_torch import grids
from transit_tpu_torch.constants import TLI_WAV_UNITS
from transit_tpu_torch.io.atmosphere import read_atmosphere
from transit_tpu_torch.io.tli import bisect_mm, read_tli_band, read_tli_header
from transit_tpu_torch.opacities import fast
from transit_tpu_torch.opacities.banded import line_kmax
from transit_tpu_torch.parallel.sharded import make_sharded_forward


def initialize(init_method: str, num_processes: int, process_id: int,
               **kw):
    """torch.distributed.init_process_group with the gloo backend for a
    band run: e.g. ``initialize("tcp://localhost:29500", 2, rank)`` or a
    ``file://`` rendezvous; ``kw`` (e.g. ``timeout``) goes on to it."""
    dist.init_process_group("gloo", init_method=init_method,
                            world_size=num_processes, rank=process_id, **kw)


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def balanced_blocks(tli_path: str, wns_v: np.ndarray, nproc: int,
                    min_bins: int = 4) -> np.ndarray:
    """Line-count-balanced contiguous coarse-bin blocks
    (multihost.py:59-106): (nproc+1,) bin boundaries, bounds[0] = 0 and
    bounds[-1] = len(wns_v); block p owns bins [bounds[p], bounds[p+1]).
    Uses O(nproc * niso * log n) memmap binary searches over the TLI's
    per-isotope wavelength-sorted line blocks (io.tli.bisect_mm)."""
    n = int(len(wns_v))
    if nproc <= 1:
        return np.array([0, n], dtype=np.int64)
    if n < nproc * min_bins:
        min_bins = max(1, n // nproc)
    hdr = read_tli_header(tli_path)
    data_off, nlines, isotran = hdr["_line_layout"]
    wl_mm = np.memmap(tli_path, dtype="<f8", mode="r", offset=data_off,
                      shape=(nlines,))
    starts = np.concatenate([[0], np.cumsum(isotran.astype(np.int64))])

    def lines_below(wn):
        """Lines with wavenumber <= wn (wavelength >= 1/wn)."""
        wl_x = 1.0 / wn / TLI_WAV_UNITS
        tot = 0
        for i in range(len(isotran)):
            blk = wl_mm[starts[i]:starts[i + 1]]
            tot += int(blk.shape[0]) - bisect_mm(blk, wl_x, side="left")
        return tot

    g_lo = lines_below(float(wns_v[0]))
    g_hi = lines_below(float(wns_v[-1]))
    bounds = [0]
    for k in range(1, nproc):
        tgt = g_lo + (g_hi - g_lo) * k / nproc
        lo_b = bounds[-1] + min_bins
        hi_b = n - (nproc - k) * min_bins
        lo, hi = lo_b, max(hi_b, lo_b + 1)
        while hi - lo > 1:
            mid = (lo + hi) // 2
            if lines_below(float(wns_v[mid])) < tgt:
                lo = mid
            else:
                hi = mid
        bounds.append(int(np.clip(lo, lo_b, hi_b)))
    bounds.append(n)
    return np.array(bounds, dtype=np.int64)


def wing_margin(cfg, databases, wns) -> float:
    """Line-selection margin (cm-1) beyond a band's window
    (multihost.py:109-127): the widest wing reach nwidth * max(alphaD,
    alphaL) over layers and isotopes (fast.max_width_bound), plus two bins
    for the tile planner's halo rounding."""
    qmol = cfg.qmol.split(",") if cfg.qmol else None
    qscale = ([float(x) for x in cfg.qscale.split(",")]
              if cfg.qscale else None)
    atm, mol = read_atmosphere(cfg.atm, cfg.molfile, qmol=qmol,
                               qscale=qscale, allowq=cfg.allowq)
    iso_mass, iso_imol = [], []
    for db in databases:
        mi = atm.species.index(db.molecule)
        for iso in db.isotopes:
            iso_mass.append(iso.mass)
            iso_imol.append(mi)
    mw = fast.max_width_bound(atm, mol, np.asarray(iso_mass), wns.f,
                              np.asarray(iso_imol, dtype=int))
    return cfg.nwidth * mw + 2.0 * wns.d


def build_band_model(cfg, num_processes: int, process_id: int,
                     mode: str = "fast", bands: int = 4, dtype=None,
                     balanced: bool = True, bounds=None, device=None):
    """The band-local TransitModel of one process (multihost.py:130-176):
    returns (model, (b0, b1), bounds); the model covers coarse bins
    [b0, b1) of the global grid with only that window's lines (and the
    wing margin's) read from the TLI.  With an opacity grid the bands
    split the grid evenly and each model reads its columns only."""
    from transit_tpu_torch.model import TransitModel
    grid_mode = bool(cfg.opacityfile and os.path.exists(cfg.opacityfile)
                     and not cfg.justOpacity)
    if not (grid_mode or mode == "fast"):
        raise ValueError("multi-process bands need the fast mode or an "
                         "opacity grid")
    wns, _ = grids.make_wn_sampling(
        wnlow=cfg.wnlow, wnhigh=cfg.wnhigh, wllow=cfg.wllow,
        wlhigh=cfg.wlhigh, wndelt=cfg.wndelt, wnosamp=cfg.wnosamp,
        wnfct=(cfg.wnfct if cfg.wnfct > 0 else 1.0), wlfct=cfg.wlfct)
    if bounds is None:
        if balanced and not grid_mode:
            bounds = balanced_blocks(cfg.linedb, wns.v, num_processes)
        else:
            # Grid interpolation costs the same per bin: an even split.
            edges = np.linspace(0, wns.n, num_processes + 1)
            bounds = np.round(edges).astype(np.int64)
    b0, b1 = int(bounds[process_id]), int(bounds[process_id + 1])
    if grid_mode:
        model = TransitModel(cfg, dtype=dtype, wn_window=(b0, b1),
                             device=device)
        return model, (b0, b1), np.asarray(bounds)

    hdr = read_tli_header(cfg.linedb)
    margin = wing_margin(cfg, hdr["databases"], wns)
    wn_lo = max(wns.i, float(wns.v[b0]) - margin)
    wn_hi = min(wns.f, float(wns.v[b1 - 1]) + margin)
    band_tli = read_tli_band(cfg.linedb, 1.0 / wn_hi / TLI_WAV_UNITS,
                             1.0 / wn_lo / TLI_WAV_UNITS)
    model = TransitModel(cfg, dtype=dtype, mode=mode, bands=bands,
                         tli=band_tli, wn_window=(b0, b1), wn_margin=margin,
                         device=device)
    return model, (b0, b1), np.asarray(bounds)


def _local_card():
    """The card of this process where there are several: LOCAL_RANK, or
    the rank, modulo the card count."""
    if not torch.cuda.is_available():
        return None
    rank = int(os.environ.get("LOCAL_RANK", process_index()))
    return torch.device("cuda", rank % torch.cuda.device_count())


class MultihostForward:
    """Multi-process band runner with a differentiable band step
    (multihost.py:179-291).  On a card the band step
    (:func:`make_sharded_forward`) and the band's kmax run as CUDA graph
    replays (JAX jits both); the collectives, on host tensors, and
    ``loss_fn`` run eagerly around them.  On the CPU every part is
    eager.

    ``forward(temps_raw, q)`` -> the global spectrum, the same on every
    process.  ``exact_ethresh`` adds the per-step kmax max-reduction, so
    that the result matches a single-process run to float association;
    without it each band cuts at its own kmax (deviations at the ethresh
    level) and one collective per step is saved.  The model goes on
    ``device``, by default this process's card (:func:`_local_card`).
    The collectives run on the world group, or on a new gloo group over
    all ranks when the world group was initialised with another
    backend."""

    def __init__(self, cfg, mode: str = "fast", bands: int = 4,
                 dtype=None, balanced: bool = True,
                 exact_ethresh: bool = True, device=None):
        self.nproc = process_count()
        self.pid = process_index()
        self.group = (dist.new_group(backend="gloo") if self.nproc > 1 and
                      dist.get_backend() != "gloo" else None)
        self.model, self.block, self.bounds = build_band_model(
            cfg, self.nproc, self.pid, mode=mode, bands=bands, dtype=dtype,
            balanced=balanced,
            device=device if device is not None else _local_card())
        if self.model.ogrid is not None:
            exact_ethresh = False       # grid mode: no line kernel
        self.exact_ethresh = exact_ethresh
        self._step = make_sharded_forward(self.model,
                                          external_kmax=exact_ethresh)
        self._kmax_fn = self._band_kmax
        if exact_ethresh and self.model.device.type == "cuda":
            from transit_tpu_torch.step_graph import GraphedStep
            self._kmax_fn = GraphedStep(self._band_kmax, self.model.dtype,
                                        self.model.device,
                                        "MultihostForward kmax", ("T",))
        self.span_max = int(np.diff(self.bounds).max())

    @property
    def n_local_lines(self) -> int:
        return self.model.tli.n_lines if self.model.tli is not None else 0

    def _t(self, x):
        return torch.as_tensor(x, dtype=self.model.dtype,
                               device=self.model.device)

    def _band_kmax(self, temps_raw):
        """The band's kmax (banded.line_kmax over its lines, layer_kmax
        on the card) at T (nl,)."""
        m = self.model
        d0 = m.bdev[0] if m.bdev is not None else m.fdev
        return line_kmax(d0, temps_raw * m.atm.tfct, m.partition(temps_raw),
                         use_kernel=m.use_kernel)

    def _global_kmax(self, temps_raw):
        """The band's kmax (:meth:`_band_kmax`, graphed on a card as
        JAX's jitted ``_kmax``, multihost.py:212-216), max-reduced over
        the processes as a host tensor outside every graph; None without
        exact_ethresh."""
        if not self.exact_ethresh:
            return None
        m = self.model
        kl = self._kmax_fn(self._t(temps_raw).detach())
        if self.nproc > 1:
            h = kl.cpu()
            dist.all_reduce(h, op=dist.ReduceOp.MAX, group=self.group)
            kl = h.to(m.device)
        return kl

    def local_spectrum(self, temps_raw, q):
        """This process's band of the spectrum (no gather)."""
        return self._step(temps_raw, q, self._global_kmax(temps_raw))

    def forward(self, temps_raw, q):
        """The global spectrum (n_coarse,) on the model's device: the
        bands, padded to the widest, all-gathered as host tensors."""
        with torch.no_grad():
            spec = self.local_spectrum(temps_raw, q)
        if self.nproc == 1:
            return spec
        buf = torch.zeros(self.span_max, dtype=spec.dtype)
        buf[:spec.shape[0]] = spec.cpu()
        out = [torch.empty_like(buf) for _ in range(self.nproc)]
        dist.all_gather(out, buf, group=self.group)
        return torch.cat([o[:self.bounds[p + 1] - self.bounds[p]]
                          for p, o in enumerate(out)]).to(spec.device)

    def value_and_grad(self, loss_fn, temps_raw, q, *loss_args):
        """The multi-process retrieval step (transit.c:118-122 run_transit,
        here with gradients): ``loss_fn(band_spec, (b0, b1), *loss_args)
        -> scalar`` is this process's share of a global loss that sums
        over wavenumber bins.  Returns (loss, (grad_temps, grad_q)), the
        same on every process: the band's loss and gradient by autograd,
        then one all-reduce SUM of [loss, dT, dq] (float64 host tensor)
        outside it; the kmax reduction (a piecewise-constant threshold)
        stays outside it too."""
        kg = self._global_kmax(temps_raw)
        T = self._t(temps_raw).detach().requires_grad_()
        qq = self._t(q).detach().requires_grad_()
        val = loss_fn(self._step(T, qq, kg), self.block, *loss_args)
        gt, gq = torch.autograd.grad(val, (T, qq))
        val = val.detach()
        if self.nproc == 1:
            return val, (gt, gq)
        flat = torch.cat([val.reshape(1), gt.reshape(-1),
                          gq.reshape(-1)]).double().cpu()
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=self.group)
        tot = flat.to(device=val.device, dtype=val.dtype)
        return (tot[0], (tot[1:1 + gt.numel()].reshape(gt.shape),
                         tot[1 + gt.numel():].reshape(gq.shape)))
