"""Wavenumber sharding of the spectrum step — the counterpart of
transit_tpu.parallel.sharded.

The physically parallel axis is wavenumber: the coarse grid is split into
B-bin blocks (B, the widest tile width), and every tile plan already
buckets to each tile the lines its wings reach (opacities/fast.py), so a
shard that owns a set of blocks owns exactly the lines of their tiles; no
halo exchange is needed.  Everything after the line extinction (CIA,
scattering, clouds, optical depth, the eclipse flux or the transit
modulation) is pointwise in wavenumber and runs on the shard's
wavenumbers through the model's own assembly (``TransitModel._assemble``).

Blocks are line-balanced: each shard gets an equal number of blocks,
chosen by greedy LPT over the per-block line-evaluation cost
(:func:`_block_costs`, :func:`_balance_blocks`), as in JAX.  A shard's
view of a tile plan keeps each tile class's tiles that fall in its blocks
(:func:`_tile_tensors_for`), and its launches are the model's launches
restricted to those tiles: the kernels read each tile's global index from
the class's table, for its wavenumber and its output column, so a shard
writes its tiles' columns of a full-width (nl, n_coarse) row buffer, from
which it takes its bins.  Padding slots (tile ids >= ntiles) hold no line
and are not launched; padding bins past n_coarse read the zero column and
are dropped by :meth:`ShardedStep.assemble`.

The shards are the ranks of a ``torch.distributed`` group, one process
per card; the group's size plays JAX's "wn" mesh axis.  Without a group
one process computes every shard (``nshard`` of them) and assembles them.
With a group, :meth:`ShardedStep.__call__` computes this rank's part and
all-gathers the parts; the gather's backward takes this rank's slice of
the cotangent, and the inputs' gradient is summed over the ranks, so a
loss that every rank computes on the gathered spectrum has the full
gradient on every rank (JAX's shard_map differentiates the same way).
Grid mode (an opacity grid, ``model.ogrid``) shards the grid's wavenumber
axis in contiguous spans (grid interpolation costs the same per bin).
Radii are static (the model's ``W``), as in JAX.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from transit_tpu_torch.opacities import fast
from transit_tpu_torch.opacities.banded import (banded_index,
                                                banded_kernel_extinction)
from transit_tpu_torch.opacities.grid import grid_extinction
from transit_tpu_torch.opacities.kernel_lbl import kernel_extinction


def _block_costs(subplans, nblk: int, B: int) -> np.ndarray:
    """Line-eval cost per B-bin block: the sum over (subplan, weight) of
    the tile line counts covering the block, weighted by the layer count
    the subplan evaluates (sharded.py:52-62)."""
    costs = np.zeros(nblk)
    for sp, w in subplans:
        tpb = B // sp.tw
        cnt = np.zeros(nblk * tpb, dtype=np.float64)
        cnt[:sp.ntiles] = sp.tile_count
        costs += w * cnt.reshape(nblk, tpb).sum(axis=1)
    return costs


def _balance_blocks(costs: np.ndarray, ndev: int):
    """Greedy LPT with equal per-shard counts: blocks by cost descending,
    each to the least-loaded shard that still has free slots
    (sharded.py:65-82).  Returns ((ndev, nblk/ndev) ascending block
    indices, (ndev,) assigned cost per shard)."""
    nblk = len(costs)
    cap = nblk // ndev
    order = np.argsort(-np.asarray(costs), kind="stable")
    loads = np.zeros(ndev)
    counts = np.zeros(ndev, dtype=np.int64)
    out = [[] for _ in range(ndev)]
    for b in order:
        free = np.flatnonzero(counts < cap)
        p = free[np.argmin(loads[free])]
        out[p].append(int(b))
        loads[p] += costs[b]
        counts[p] += 1
    return np.array([sorted(o) for o in out], dtype=np.int64), loads


def _tile_tensors_for(sp, flat_tiles: np.ndarray, dtype, device,
                      lmax: int = None):
    """Line tensors of the tiles ``flat_tiles`` of the plan ``sp``, padded
    to ``lmax`` lines (default the plan's), with "gidx", their int32
    global indices (sharded.py:85-95); indices >= sp.ntiles are padding
    slots, whose mask is empty."""
    flat_tiles = np.asarray(flat_tiles)
    valid = flat_tiles < sp.ntiles
    t = fast._tile_tensors(sp, np.minimum(flat_tiles, sp.ntiles - 1),
                           sp.lmax if lmax is None else lmax, dtype, device)
    t["mask"] = t["mask"] & torch.as_tensor(valid[:, None], device=device)
    t["gidx"] = torch.as_tensor(flat_tiles, dtype=torch.int32, device=device)
    return t


def _restrict(sp, tiles: np.ndarray, dtype, device):
    """The plan ``sp`` restricted to its tiles in ``tiles`` (ascending
    global indices < sp.ntiles): the plan with those tiles as its classes
    (each class of ``sp`` keeps its lmax; a plan without classes becomes
    one class) and {"classes": their line tensors}."""
    if sp.class_tiles is None:
        cls = [(tiles, sp.lmax)]
    else:
        cls = [(ct[np.isin(ct, tiles)], lm)
               for ct, lm in zip(sp.class_tiles, sp.class_lmax)]
        cls = [(ct, lm) for ct, lm in cls if ct.size]
    plan = dataclasses.replace(sp, class_tiles=[c.astype(np.int32)
                                                for c, _ in cls],
                               class_lmax=[lm for _, lm in cls])
    return plan, {"classes": [_tile_tensors_for(sp, c, dtype, device, lm)
                              for c, lm in cls]}


def _shared(d):
    """A plan's tensors that every shard reads whole: the full line list
    (the kmax scan, so that its ethresh cut is global) and the isotope
    tables."""
    return {k: v for k, v in d.items() if k.startswith(("all_", "iso_"))}


class _Gather(torch.autograd.Function):
    """All-gather of equal-sized parts over ``group``: (span,) ->
    (nshard * span,), rank after rank; the backward takes this rank's
    slice of the cotangent (the loss is the same on every rank)."""

    @staticmethod
    def forward(ctx, part, group, nshard: int, rank: int):
        ctx.rank, ctx.span = rank, part.shape[0]
        out = [torch.empty_like(part) for _ in range(nshard)]
        torch.distributed.all_gather(out, part.contiguous(), group=group)
        return torch.cat(out)

    @staticmethod
    def backward(ctx, g):
        a = ctx.rank * ctx.span
        return g[a:a + ctx.span], None, None, None


class _SumGrad(torch.autograd.Function):
    """Identity whose backward sums the cotangent over ``group``: an input
    that every rank holds, whose gradient each rank computes through its
    own part only."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        torch.distributed.all_reduce(g, group=ctx.group)
        return g, None


class ShardedStep:
    """The sharded spectrum step of :func:`make_sharded_forward`:
    ``step(temps_raw, q[, kmax])`` -> spectrum (n_coarse,);
    ``step.local(shard, temps_raw, q, kmax=None)`` -> one shard's
    (span,) part; ``step.assemble(parts)`` -> the parts in grid order;
    ``step.eval_stats`` (line modes): {"actual_evals": (nshard,) assigned
    cost, "blocks": (nshard, nblk/nshard) block indices, "block_costs":
    (nblk,)}; ``step.bins``: (nshard, span) global bins of each shard."""

    def __init__(self, model, group=None, external_kmax: bool = False,
                 balance: bool = True, nshard: int = None):
        grid_mode = model.ogrid is not None
        if not grid_mode and model.mode != "fast":
            raise ValueError("the sharded step needs mode='fast' or an "
                             "opacity grid")
        size = 1 if group is None else torch.distributed.get_world_size(
            group)
        nshard = size if nshard is None else nshard
        if group is not None and nshard != size:
            raise ValueError(f"nshard {nshard}: the group has {size} ranks")
        self.model, self.group, self.nshard = model, group, nshard
        self.rank = 0 if group is None else torch.distributed.get_rank(group)
        self.external_kmax = external_kmax
        self.grid_mode = grid_mode
        self.banded = not grid_mode and model.bplan is not None
        n_coarse = model.wns.n
        self.eval_stats = None
        if grid_mode:
            span = -(-n_coarse // nshard)
            bins = np.arange(nshard * span).reshape(nshard, span)
        else:
            B, cost_subs = self._cost_subplans()
            span = (-(-n_coarse // (nshard * B))) * B      # bins per shard
            nblk_local = span // B
            nblk = nshard * nblk_local
            costs = _block_costs(cost_subs, nblk, B)
            if balance and nshard > 1:
                blocks, loads = _balance_blocks(costs, nshard)
            else:
                blocks = np.arange(nblk).reshape(nshard, nblk_local)
                loads = costs.reshape(nshard, nblk_local).sum(axis=1)
            self.eval_stats = {"actual_evals": loads, "blocks": blocks,
                               "block_costs": costs}
            self._B, self._blocks = B, blocks
            bins = (blocks[:, :, None] * B +
                    np.arange(B)[None, None, :]).reshape(nshard, span)
        self.span, self.bins = span, bins
        # Gather order -> grid order: the position of each global bin in
        # the concatenated parts.
        pos = np.empty(nshard * span, dtype=np.int64)
        pos[bins.reshape(-1)] = np.arange(nshard * span)
        self._unperm = torch.as_tensor(pos[:n_coarse], device=model.device)
        # Per shard: the columns of its bins in a full-width buffer padded
        # by one zero column (padding bins read column n_coarse), and its
        # (raw, cgs) wavenumbers, the model's grid values (padding bins
        # take the last one).
        self._cols = [torch.as_tensor(np.minimum(b, n_coarse),
                                      device=model.device) for b in bins]
        wn = [model.wns.v[np.minimum(b, n_coarse - 1)] for b in bins]
        self._wn = [(model._t(w), model._t(w * model.wns.fct)) for w in wn]
        self._views = {}

    def _cost_subplans(self):
        """(B, [(subplan, layer weight)]) of the block costs
        (sharded.py:147-172): decimated shells weigh (tw/s + 3)/tw of
        their bins' evaluations."""
        m = self.model
        nl = m.atm.nlayers
        if not self.banded:
            return m.fplan.tw, [(m.fplan, float(nl))]
        bplan = m.bplan
        B = max(p.tw for p in bplan.plans)
        subs = []
        for i, p in enumerate(bplan.plans):
            a, b = bplan.slices[i]
            far = bplan.far_plans[i] if bplan.far_plans is not None else None
            parts = [(p, 0)] + [(fp, s) for pL, pR, s in (far or [])
                                for fp in (pL, pR) if fp is not None]
            for sp, stride in parts:
                if B % sp.tw:
                    raise ValueError("band tile widths must divide the "
                                     "block")
                frac = (1.0 if stride <= 1
                        else (sp.tw // stride + 3) / sp.tw)
                subs.append((sp, float(b - a) * frac))
        return B, subs

    def _tiles(self, shard: int, sp) -> np.ndarray:
        """The shard's tiles of the plan ``sp``: the tiles of its blocks,
        padding slots left out."""
        tpb = self._B // sp.tw
        t = (self._blocks[shard][:, None] * tpb +
             np.arange(tpb)[None, :]).reshape(-1)
        return t[t < sp.ntiles]

    def _view(self, shard: int):
        """(plan or banded plan, tensors, kernel index) of the shard's
        tiles, or in grid mode a 1-tuple of the grid's columns of its
        bins; made at the shard's first step; one shard is the model's
        own."""
        if shard in self._views:
            return self._views[shard]
        m = self.model
        if self.grid_mode:
            view = (m._ogrid_t if self.nshard == 1 else
                    m._ogrid_t[..., self._cols[shard].clamp(
                        max=m.wns.n - 1)].contiguous(),)
        elif self.nshard == 1:
            view = ((m.bplan, m.bdev, m.bindex) if self.banded else
                    (m.fplan, m.fdev, None))
        elif not self.banded:
            plan, d = _restrict(m.fplan, self._tiles(shard, m.fplan),
                                m.dtype, m.device)
            view = (plan, {**d, **_shared(m.fdev)}, None)
        else:
            bplan, plans, devs, far_plans = m.bplan, [], [], []
            for i, p in enumerate(bplan.plans):
                plan, d = _restrict(p, self._tiles(shard, p), m.dtype,
                                    m.device)
                d.update(_shared(m.bdev[0]))
                far = bplan.far_plans[i] if bplan.far_plans is not None \
                    else None
                if far:
                    shells = [_restrict(fp, self._tiles(shard, fp), m.dtype,
                                        m.device) + (s,)
                              for fp, _, s in far]
                    far = [(fp, None, s) for fp, _, s in shells]
                    d["far"] = [(fd, None) for _, fd, _ in shells]
                plans.append(plan)
                far_plans.append(far)
                devs.append(d)
            bview = dataclasses.replace(
                bplan, plans=plans,
                far_plans=None if bplan.far_plans is None else far_plans)
            view = (bview, devs, banded_index(bview, devs, m.device)
                    if m.device.type == "cuda" else None)
        self._views[shard] = view
        return view

    def _line_extinction(self, shard: int, temps_cgs, densities, Z, kmax):
        """The shard's line extinction (nl, span)."""
        m = self.model
        if self.grid_mode:
            return grid_extinction(m._ogrid_temp_t, self._view(shard)[0],
                                   m._grid_mol_t, temps_cgs, densities)
        plan, d, index = self._view(shard)
        args = (temps_cgs, densities, Z, m._molm_t, m._molrad_t)
        kw = dict(wn_i=m.wns.i, dwn=m.wns.d, ethresh=m.cfg.ethreshold,
                  nwidth=m.cfg.nwidth, use_kernel=m.use_kernel,
                  kmax_override=kmax)
        if self.banded:
            full = banded_kernel_extinction(plan, d, *args, index=index,
                                            **kw)
        else:
            full = kernel_extinction(plan, d, *args, **kw)
        return torch.nn.functional.pad(full, (0, 1))[:, self._cols[shard]]

    def local(self, shard: int, temps_raw, q, kmax=None):
        """One shard's part (span,) of the spectrum for T (nl,) and q
        (nmol, nl) (JAX's local_step, sharded.py:241-337): its line
        extinction (``kmax``, (nl,): the external per-layer kmax of the
        multi-process bands, a constant; None: the scan over the model's
        whole line list), then the model's assembly at its wavenumbers.
        Differentiable in T and q."""
        if self.external_kmax != (kmax is not None) and not self.grid_mode:
            raise ValueError("a step made with external_kmax takes kmax, "
                             "another takes none")
        m = self.model
        temps_raw, q, densities = m._profiles(temps_raw, q)
        temps_cgs = temps_raw * m.atm.tfct
        ex = self._line_extinction(shard, temps_cgs, densities,
                                   None if self.grid_mode else
                                   m.partition(temps_raw), kmax)
        return m._assemble(temps_raw, q, densities, ex, False,
                           wn=self._wn[shard])

    def assemble(self, parts):
        """The parts of every shard, in shard order, as the spectrum
        (n_coarse,) in grid order."""
        return torch.cat(list(parts))[self._unperm]

    def __call__(self, temps_raw, q, kmax=None):
        """The spectrum (n_coarse,): without a group every shard's part,
        assembled; with one this rank's part, all-gathered over the group
        (differentiable, see the module docstring)."""
        if self.group is None:
            return self.assemble([self.local(s, temps_raw, q, kmax)
                                  for s in range(self.nshard)])
        m = self.model
        T = _SumGrad.apply(torch.as_tensor(temps_raw, dtype=m.dtype,
                                           device=m.device), self.group)
        qq = _SumGrad.apply(torch.as_tensor(q, dtype=m.dtype,
                                            device=m.device), self.group)
        part = self.local(self.rank, T, qq, kmax)
        return _Gather.apply(part, self.group, self.nshard,
                             self.rank)[self._unperm]


def make_sharded_forward(model, group=None, external_kmax: bool = False,
                         balance: bool = True, nshard: int = None):
    """The sharded spectrum step of a fast-mode TransitModel (banded or
    not) or of one with an opacity grid (transit_tpu
    make_sharded_forward, sharded.py:98-359): a :class:`ShardedStep`.

    ``group``: the ``torch.distributed`` group whose ranks are the shards
    (one process per card); None: one process, ``nshard`` shards (default
    1), all computed by ``step(...)``.  ``external_kmax``: the step takes
    a per-layer kmax computed elsewhere (the multi-process bands' global
    kmax, so that every band cuts at the same ethresh level,
    extinction.c:467-470).  ``balance`` assigns blocks to shards by
    line-eval cost; False keeps contiguous equal spans."""
    return ShardedStep(model, group, external_kmax, balance, nshard)
