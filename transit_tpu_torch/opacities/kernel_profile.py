"""The profile scatter of exact mode through the CUDA kernels of
csrc/profile_scatter.cu — the counterpart of the windowed gather and
scatter-add of transit_tpu.opacities.lbl.layer_extinction (lbl.py:245-271).

``profile_scatter`` and ``profile_scatter_backward`` launch the forward
and backward kernels (ctypes, one launch each for all layers: a block
per layer and tile of consecutive groups, lbl.scatter_tiles);
:class:`ProfileScatter` is the differentiable function of the group
strengths g_k around them, which takes their plain PyTorch versions
(lbl.profile_scatter_plain and lbl.profile_scatter_plain_vjp) for CPU
tensors or with ``use_kernel=False``.  On a CUDA tensor it launches the
kernel or raises: nothing on the card gives way to the plain version.
:func:`ChunkedExtinction` is exact mode's line extinction of layers in
chunks (lbl.layer_extinction, when the layers do not fit one chunk of
lbl.chunk_rows): lbl.layer_groups and one scatter launch a chunk, and a
backward that recomputes a chunk's group tables at a time.
:func:`profile_scatter_permol` is the opacity-grid build's per-molecule
scatter (no gradient): the same forward kernel, each tile adding to its
output molecule's row.  ``doppler_fill`` launches the Doppler index's
forward fill of lbl.layer_groups (csrc/doppler_fill.cu);
:func:`doppler_fill_fn` is the one way every caller reaches it or its
plain version, lbl.doppler_fill_plain.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from transit_tpu_torch.opacities.kernel_lbl import (_check_cuda, _ptr,
                                                    fold_batch)
from transit_tpu_torch.opacities.lbl import (ScatterTables, check_tiles,
                                             doppler_fill_plain,
                                             layer_groups,
                                             profile_scatter_plain,
                                             profile_scatter_plain_vjp,
                                             row_slices)
from transit_tpu_torch.utils import log
from transit_tpu_torch.utils.log import span


def _check_launch(fn: str, per_group: dict, ilor, s: ScatterTables):
    """Check a launch's tensors: the (nl, ng) per-group arguments, ilor
    (nl, niso) and the scatter tables, on one CUDA device, float32 or
    int32 (``keep`` uint8); returns (device, nl, ng, niso, their
    contiguous tensors by name)."""
    args = {**per_group, "ilor": ilor, "g_iso": s.g_iso, "g_iown": s.g_iown,
            "g_idwn": s.g_idwn, "profsize": s.profsize,
            "profbase": s.profbase, "profflat": s.profflat, "tiles": s.tiles}
    device = _check_cuda(fn, args, ints=("g_idop", "ilor", "g_iso",
                                         "g_iown", "g_idwn", "profsize",
                                         "profbase", "tiles"), u8=("keep",))
    nl, ng = per_group["g_idop"].shape
    for name, t in per_group.items():
        if tuple(t.shape) != (nl, ng):
            raise ValueError(f"{fn}: {name} has shape {tuple(t.shape)}, "
                             f"not ({nl}, {ng})")
    for name in ("g_iso", "g_iown", "g_idwn"):
        if tuple(args[name].shape) != (ng,):
            raise ValueError(f"{fn}: {name} must be ({ng},)")
    if ilor.dim() != 2 or ilor.shape[0] != nl:
        raise ValueError(f"{fn}: ilor must be ({nl}, niso)")
    if s.profsize.dim() != 2 or s.profbase.shape != s.profsize.shape:
        raise ValueError(f"{fn}: profsize and profbase must be (ndop, "
                         f"nlor)")
    if s.profflat.dim() != 1 or s.profflat.shape[0] >= 2 ** 31:
        raise ValueError(f"{fn}: profflat must be 1-d, < 2**31 values")
    if s.ofactor <= 0 or s.n_coarse <= 0:
        raise ValueError(f"{fn}: ofactor and n_coarse must be positive")
    _check_tiles(fn, s.tiles, ng)
    return (device, nl, ng, ilor.shape[1],
            {k: v.contiguous() for k, v in args.items()})


def _check_tiles(fn: str, tiles, ng: int):
    """lbl.check_tiles of a launch's tile table, read to the host once
    per tensor (the model passes the same one at every forward; the
    kernels would drop the groups of a malformed one)."""
    if getattr(tiles, "_checked_for_ng", None) == ng:
        return
    try:
        check_tiles(tiles.cpu().numpy(), ng)
    except ValueError as e:
        raise ValueError(f"{fn}: {e}") from None
    tiles._checked_for_ng = ng


def _tables(s: ScatterTables, args) -> tuple:
    return tuple(_ptr(args[k]) for k in ("ilor", "g_iso", "g_iown", "g_idwn",
                                        "profsize", "profbase", "profflat",
                                        "tiles"))


def _sizes(s: ScatterTables, nl, ng, niso) -> tuple:
    """The entry points' int arguments: nl, ng, ntiles, niso, nlor,
    ofactor, n_coarse."""
    return (nl, ng, s.tiles.shape[0] - 1, niso, s.profsize.shape[1],
            s.ofactor, s.n_coarse)


def _tile_mol(s: ScatterTables, device, ntiles: int):
    """The forward launch's per-tile output molecules: None for the
    collapsed extinction, else s.tile_mol checked ((ntiles,) int32 on
    ``device``; lbl.permol_tables checked its values)."""
    if s.tile_mol is None:
        if s.nm != 1:
            raise ValueError("profile_scatter: nm > 1 needs tile_mol "
                             "(lbl.permol_tables)")
        return None
    t = s.tile_mol
    if (t.dtype != torch.int32 or t.device != device or
            tuple(t.shape) != (ntiles,)):
        raise ValueError(f"profile_scatter: tile_mol must be a ({ntiles},) "
                         f"int32 tensor on {device}")
    return t.contiguous()


def profile_scatter(g_k, g_idop, ilor, s: ScatterTables, stats=None):
    """Launch ``profile_scatter`` (csrc/profile_scatter.cu): the group
    strengths g_k (nl, ng) float32 (0 where a group is not kept), their
    Doppler indices g_idop (nl, ng) and the Lorentz indices ilor (nl,
    niso), int32 -> the extinction (nl, n_coarse) float32 on their CUDA
    device (lbl.profile_scatter_plain on the card); with per-molecule
    rows (s.tile_mol, lbl.permol_tables) (nl, s.nm, n_coarse), each tile
    adding to its molecule's row.  A block per (layer, tile of s.tiles);
    a tile whose span (lbl.tile_spans) exceeds lbl.SCATTER_SEGMENT adds
    to the output in global memory.  ``stats``, a (1,) int64 tensor on
    the card, gets the (layer, group, j) pairs added (lbl.scatter_pairs
    counts the same on the host).  Raises on any other device, type or
    shape, and when the launch fails."""
    from transit_tpu_torch.opacities._build import load_library

    device, nl, ng, niso, args = _check_launch(
        "profile_scatter", {"g_k": g_k, "g_idop": g_idop}, ilor, s)
    if stats is not None and (stats.dtype != torch.int64 or
                              tuple(stats.shape) != (1,) or
                              stats.device != device):
        raise ValueError(f"profile_scatter: stats must be a (1,) int64 "
                         f"tensor on {device}")
    tile_mol = _tile_mol(s, device, s.tiles.shape[0] - 1)
    shape = (nl, s.n_coarse) if tile_mol is None else (nl, s.nm, s.n_coarse)
    out = torch.zeros(shape, dtype=torch.float32, device=device)
    if nl == 0 or ng == 0:
        return out
    with torch.cuda.device(device):
        lib = load_library()
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.profile_scatter(
            _ptr(args["g_k"]), _ptr(args["g_idop"]), *_tables(s, args),
            _ptr(tile_mol), _ptr(out), _ptr(stats),
            *_sizes(s, nl, ng, niso), s.nm, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"profile_scatter failed to launch: CUDA error "
                           f"{err}")
    profile_scatter.launches += 1
    log.launched("profile_scatter_kernel")
    return out


def profile_scatter_backward(ct, keep, g_idop, ilor, s: ScatterTables):
    """Launch ``profile_scatter_backward`` (csrc/profile_scatter.cu): the
    cotangent ct (nl, n_coarse) float32 of the scatter's output -> the
    cotangent of g_k (nl, ng) float32, 0 where ``keep`` (nl, ng, bool or
    uint8) is false (lbl.profile_scatter_plain_vjp on the card, bit for
    bit).  A tile whose span exceeds lbl.SCATTER_SEGMENT reads ct from
    global memory.  Raises on any other device, type or shape, and when
    the launch fails."""
    from transit_tpu_torch.opacities._build import load_library

    keep = keep.to(torch.uint8)
    device, nl, ng, niso, args = _check_launch(
        "profile_scatter_backward", {"keep": keep, "g_idop": g_idop}, ilor, s)
    if (ct.dtype != torch.float32 or ct.device != device or
            tuple(ct.shape) != (nl, s.n_coarse)):
        raise ValueError(f"profile_scatter_backward: ct must be a ({nl}, "
                         f"{s.n_coarse}) float32 tensor on {device}")
    ct = ct.contiguous()
    grad = torch.empty((nl, ng), dtype=torch.float32, device=device)
    if nl == 0 or ng == 0:
        return grad
    with torch.cuda.device(device):
        lib = load_library()
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.profile_scatter_backward(
            _ptr(args["keep"]), _ptr(args["g_idop"]), *_tables(s, args),
            _ptr(ct), _ptr(grad), *_sizes(s, nl, ng, niso),
            ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"profile_scatter_backward failed to launch: CUDA "
                           f"error {err}")
    profile_scatter_backward.launches += 1
    log.launched("profile_scatter_bwd_kernel")
    return grad


class ProfileScatter(torch.autograd.Function):
    """The profile scatter as a differentiable function of the group
    strengths g_k (nl, ng): ``profile_scatter`` forward and
    ``profile_scatter_backward`` backward with ``kernel``, else their
    plain versions.  The indices (keep, g_idop, ilor) are integers and
    carry no gradient, as in JAX.  torch.func transforms it: the function
    is independent per layer, so the vmap rule folds the batch into extra
    layers, and the backward runs through :class:`ProfileScatterVjp`,
    whose vmap rule does the same."""

    @staticmethod
    def forward(g_k, keep, g_idop, ilor, s: ScatterTables, kernel: bool):
        if kernel:
            return profile_scatter(g_k, g_idop, ilor, s)
        return profile_scatter_plain(g_k, g_idop, ilor, s)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, keep, g_idop, ilor, s, kernel = inputs
        ctx.save_for_backward(keep, g_idop, ilor)
        ctx.s, ctx.kernel = s, kernel

    @staticmethod
    def backward(ctx, ct):
        keep, g_idop, ilor = ctx.saved_tensors
        with span("scatter.bwd"):
            g_k = ProfileScatterVjp.apply(ct, keep, g_idop, ilor, ctx.s,
                                          ctx.kernel)
        return g_k, None, None, None, None, None

    @staticmethod
    def vmap(info, in_dims, g_k, keep, g_idop, ilor, s, kernel):
        B = info.batch_size
        args = [fold_batch(x, d, B) for x, d in
                zip((g_k, keep, g_idop, ilor), in_dims[:4])]
        out = ProfileScatter.apply(*args, s, kernel)
        return out.reshape(B, -1, s.n_coarse), 0


class ProfileScatterVjp(torch.autograd.Function):
    """The backward of :class:`ProfileScatter`: the cotangent of its
    output -> that of g_k (``profile_scatter_backward`` with ``kernel``,
    else lbl.profile_scatter_plain_vjp).  Its vmap rule folds the batch
    into layers; it has no derivative of its own."""

    @staticmethod
    def forward(ct, keep, g_idop, ilor, s: ScatterTables, kernel: bool):
        if kernel:
            return profile_scatter_backward(ct, keep, g_idop, ilor, s)
        return profile_scatter_plain_vjp(ct, keep, g_idop, ilor, s)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, _):
        raise NotImplementedError("the profile scatter has no second "
                                  "derivative")

    @staticmethod
    def vmap(info, in_dims, ct, keep, g_idop, ilor, s, kernel):
        B = info.batch_size
        args = [fold_batch(x, d, B) for x, d in
                zip((ct, keep, g_idop, ilor), in_dims[:4])]
        return ProfileScatterVjp.apply(*args, s, kernel).reshape(
            B, -1, args[2].shape[1]), 0


@dataclasses.dataclass
class LayerChunks:
    """What :class:`ChunkedExtinction` needs besides its rows' temperatures,
    densities and Z: lbl.layer_groups' device arrays ``d``, molecule
    masses and radii, ``wn0`` and ``ethresh``; the scatter tables ``s``;
    ``kernel`` (the kernels, else the plain versions) and the ``rows`` of
    a chunk."""
    d: dict
    s: ScatterTables
    mol_mass: torch.Tensor
    mol_radius: torch.Tensor
    wn0: float
    ethresh: float
    kernel: bool
    rows: int

    def groups(self, temps, densities, Z) -> dict:
        return layer_groups(self.d, temps, densities, Z, self.mol_mass,
                            self.mol_radius, self.wn0, self.ethresh,
                            use_kernel=self.kernel)


def fold_columns(x, dim, B: int):
    """A vmapped (n, nl) argument (densities, Z) with its batch at ``dim``
    (None: shared by every member) as (n, B * nl), member after member
    (the rows of fold_batch)."""
    x = x.movedim(dim, 0) if dim is not None else x.expand(B, *x.shape)
    return x.transpose(0, 1).reshape(x.shape[1], -1)


class ChunkedExtinction(torch.autograd.Function):
    """Exact mode's line extinction (nl, n_coarse) of temps (nl,),
    densities (nmol, nl) and Z (niso, nl), ``op.rows`` layers at a time
    (:class:`LayerChunks`): per chunk lbl.layer_groups and one
    ``profile_scatter`` launch (the plain scatter without ``op.kernel``),
    the chunk's output into its rows.  It saves only its inputs; the
    backward (:class:`ChunkedExtinctionVjp`) recomputes one chunk's group
    tables at a time, so no chunk's tables outlive it.  The vmap rule
    folds the batch into the rows (member after member) and chunks
    those."""

    @staticmethod
    def forward(temps, densities, Z, op: LayerChunks):
        parts = []
        for sl in row_slices(temps.shape[0], op.rows):
            with span("chunk"):
                grp = op.groups(temps[sl], densities[:, sl], Z[:, sl])
                with span("scatter"):
                    args = (grp["g_k"], grp["g_idop"], grp["ilor"], op.s)
                    parts.append(profile_scatter(*args) if op.kernel else
                                 profile_scatter_plain(*args))
                del grp, args
        with span("scatter"):
            return torch.cat(parts)

    @staticmethod
    def setup_context(ctx, inputs, output):
        temps, densities, Z, op = inputs
        ctx.save_for_backward(temps, densities, Z)
        ctx.op = op

    @staticmethod
    def backward(ctx, ct):
        return (*ChunkedExtinctionVjp.apply(ct, *ctx.saved_tensors, ctx.op),
                None)

    @staticmethod
    def vmap(info, in_dims, temps, densities, Z, op):
        B = info.batch_size
        out = ChunkedExtinction.apply(
            fold_batch(temps, in_dims[0], B),
            fold_columns(densities, in_dims[1], B),
            fold_columns(Z, in_dims[2], B), op)
        return out.reshape(B, -1, op.s.n_coarse), 0


class ChunkedExtinctionVjp(torch.autograd.Function):
    """The backward of :class:`ChunkedExtinction`: the cotangent ct (nl,
    n_coarse) -> those of temps, densities and Z.  Per chunk: the group
    tables again, under torch.func.vjp (the autograd graph of one chunk),
    the cotangent of g_k (``profile_scatter_backward``, or
    lbl.profile_scatter_plain_vjp), and the VJP of the tables into the
    chunk's rows.  Its vmap rule folds the batch into the rows; it has no
    derivative of its own."""

    @staticmethod
    def forward(ct, temps, densities, Z, op: LayerChunks):
        with span("groups.vjp"):
            grads = tuple(torch.zeros_like(x) for x in (temps, densities, Z))
        vjp_of = profile_scatter_backward if op.kernel else \
            profile_scatter_plain_vjp

        def g_k(t, dn, z):
            grp = op.groups(t, dn, z)
            return grp["g_k"], (grp["keep"], grp["g_idop"], grp["ilor"])

        for sl in row_slices(temps.shape[0], op.rows):
            with span("chunk"):
                with span("groups.recompute"):
                    _, vjp, (keep, g_idop, ilor) = torch.func.vjp(
                        g_k, temps[sl], densities[:, sl], Z[:, sl],
                        has_aux=True)
                with span("scatter.bwd"):
                    ct_g = vjp_of(ct[sl], keep, g_idop, ilor, op.s)
                with span("groups.vjp"):
                    gT, gD, gZ = vjp(ct_g)
                    grads[0][sl], grads[1][:, sl], grads[2][:, sl] = \
                        gT, gD, gZ
                del vjp, keep, g_idop, ilor, ct_g, gT, gD, gZ
        return grads

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *_):
        raise NotImplementedError("the chunked line extinction has no "
                                  "second derivative")

    @staticmethod
    def vmap(info, in_dims, ct, temps, densities, Z, op):
        B = info.batch_size
        gT, gD, gZ = ChunkedExtinctionVjp.apply(
            fold_batch(ct, in_dims[0], B), fold_batch(temps, in_dims[1], B),
            fold_columns(densities, in_dims[2], B),
            fold_columns(Z, in_dims[3], B), op)
        return ((gT.reshape(B, -1), gD.reshape(gD.shape[0], B, -1),
                 gZ.reshape(gZ.shape[0], B, -1)), (0, 1, 1))


def profile_scatter_permol(grp: dict, s: ScatterTables,
                           use_kernel: bool = True):
    """The per-molecule extinction (nl, s.nm, n_coarse) of
    lbl.layer_groups' tables ``grp`` (made with ``nm``) on the
    per-molecule tables ``s`` (lbl.permol_tables), without gradient:
    ``profile_scatter`` when g_k lies on a CUDA device and
    ``use_kernel``, else its plain version."""
    args = (grp["g_k"].detach(), grp["g_idop"], grp["ilor"], s)
    if use_kernel and args[0].device.type == "cuda":
        return profile_scatter(*args)
    return profile_scatter_plain(*args)


def profile_scatter_fn(grp: dict, s: ScatterTables, use_kernel: bool = True):
    """The extinction (nl, n_coarse) of lbl.layer_groups' tables ``grp``
    through :class:`ProfileScatter`: the kernels when g_k lies on a CUDA
    device and ``use_kernel``, else the plain versions."""
    kernel = use_kernel and grp["g_k"].device.type == "cuda"
    return ProfileScatter.apply(grp["g_k"], grp["keep"], grp["g_idop"],
                                grp["ilor"], s, kernel)


# Groups of one segment of the Doppler fill (csrc/doppler_fill.cu DF_SEG):
# the scratch holds one int a (row, segment).
DOPPLER_SEGMENT = 1024
# The most aDop entries the fill kernel stages in shared memory
# (DF_MAX_NDOP).
DOPPLER_MAX_NDOP = 4096


def _launch_ok(fn: str, err: int, kernel: str):
    if err != 0:
        raise RuntimeError(f"{fn} failed to launch: CUDA error {err}")
    log.launched(kernel)


def doppler_fill(keep, alphad, alphal, idop0, g_iso, g_wavn, g_iso_start,
                 aDop):
    """Launch the Doppler fill (csrc/doppler_fill.cu: doppler_last,
    doppler_carry and doppler_fill, in turn on the current stream): keep
    (rows, ng) bool, the rows' widths alphad and alphal (rows, niso)
    float32 and initial indices idop0 (rows, niso) int64, the plan's
    g_iso and g_iso_start (ng,) int32, g_wavn (ng,) and aDop (ndop,)
    float32 -> g_idop (rows, ng) int32 on their CUDA device, bit for bit
    lbl.doppler_fill_plain's.  The scratch is (rows, ceil(ng /
    DOPPLER_SEGMENT)) int32.  One call counts one launch.  Raises on any
    other device, type or shape, and when a launch fails."""
    from transit_tpu_torch.opacities._build import load_library

    args = {"alphad": alphad, "alphal": alphal, "g_iso": g_iso,
            "g_wavn": g_wavn, "g_iso_start": g_iso_start, "aDop": aDop}
    device = _check_cuda("doppler_fill", args,
                         ints=("g_iso", "g_iso_start"), u8=())
    for name, t, want in (("keep", keep, torch.bool),
                          ("idop0", idop0, torch.int64)):
        if t.dtype != want or t.device != device:
            raise TypeError(f"doppler_fill: {name} must be {want} on "
                            f"{device}, not {t.dtype} on {t.device}")
    if keep.dim() != 2 or alphad.dim() != 2:
        raise ValueError("doppler_fill: keep must be (rows, ng) and alphad "
                         "(rows, niso)")
    rows, ng = keep.shape
    niso = alphad.shape[1]
    for name, t in (("alphal", alphal), ("idop0", idop0)):
        if tuple(t.shape) != (rows, niso):
            raise ValueError(f"doppler_fill: {name} has shape "
                             f"{tuple(t.shape)}, not ({rows}, {niso})")
    for name in ("g_iso", "g_wavn", "g_iso_start"):
        if tuple(args[name].shape) != (ng,):
            raise ValueError(f"doppler_fill: {name} must be ({ng},)")
    ndop = aDop.shape[0]
    if aDop.dim() != 1 or not 2 <= ndop <= DOPPLER_MAX_NDOP:
        raise ValueError(f"doppler_fill: aDop must be 1-d, 2 to "
                         f"{DOPPLER_MAX_NDOP} values")
    out = torch.empty((rows, ng), dtype=torch.int32, device=device)
    if rows == 0 or ng == 0:
        return out
    if niso == 0:
        raise ValueError("doppler_fill: no isotope widths")
    nseg = -(-ng // DOPPLER_SEGMENT)
    last = torch.empty((rows, nseg), dtype=torch.int32, device=device)
    keep = keep.contiguous().view(torch.uint8)
    a = {k: v.contiguous() for k, v in args.items()}
    ad, al, i0 = (x.contiguous() for x in (alphad, alphal, idop0))
    with torch.cuda.device(device):
        lib = load_library()
        stream = ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
        _launch_ok("doppler_last", lib.doppler_last(
            _ptr(keep), _ptr(ad), _ptr(al), _ptr(a["g_iso"]),
            _ptr(a["g_wavn"]), _ptr(last), rows, ng, nseg, niso, stream),
            "doppler_last_kernel")
        _launch_ok("doppler_carry", lib.doppler_carry(
            _ptr(last), rows, nseg, stream), "doppler_carry_kernel")
        _launch_ok("doppler_fill", lib.doppler_fill(
            _ptr(keep), _ptr(ad), _ptr(al), _ptr(i0), _ptr(a["g_iso"]),
            _ptr(a["g_wavn"]), _ptr(a["g_iso_start"]), _ptr(a["aDop"]),
            _ptr(last), _ptr(out), rows, ng, nseg, niso, ndop, stream),
            "doppler_fill_kernel")
    doppler_fill.launches += 1
    return out


class DopplerFill(torch.autograd.Function):
    """``doppler_fill`` as a function torch.func transforms (the
    recompute under torch.func.vjp, vmap of the forward): its output is
    an integer index and carries no gradient; the vmap rule folds the
    batch into the rows (the plan's tables are shared)."""

    @staticmethod
    def forward(keep, alphad, alphal, idop0, g_iso, g_wavn, g_iso_start,
                aDop):
        return doppler_fill(keep, alphad, alphal, idop0, g_iso, g_wavn,
                            g_iso_start, aDop)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mark_non_differentiable(output)

    @staticmethod
    def backward(ctx, _):
        return (None,) * 8

    @staticmethod
    def vmap(info, in_dims, keep, alphad, alphal, idop0, *plan):
        if any(d is not None for d in in_dims[4:]):
            raise ValueError("doppler_fill: the plan's tables are shared "
                             "by the batch")
        B = info.batch_size
        rows = [fold_batch(x, d, B) for x, d in
                zip((keep, alphad, alphal, idop0), in_dims[:4])]
        out = DopplerFill.apply(*rows, *plan)
        return out.reshape(B, -1, out.shape[1]), 0


def doppler_fill_fn(keep, alphad, alphal, idop0, d: dict,
                    use_kernel: bool = True):
    """The Doppler fill of lbl.layer_groups, for every caller: keep (rows,
    ng), alphad, alphal and idop0 (rows, niso), the plan's g_iso, g_wavn,
    g_iso_start and aDop from ``d`` -> g_idop (rows, ng) int32, through
    :class:`DopplerFill` (the kernel) when keep lies on a CUDA device and
    ``use_kernel``, else lbl.doppler_fill_plain."""
    args = (keep, alphad, alphal, idop0, d["g_iso"], d["g_wavn"],
            d["g_iso_start"], d["aDop"])
    if use_kernel and keep.device.type == "cuda":
        return DopplerFill.apply(*args)
    return doppler_fill_plain(*args)


# Kernel launches since the last reset (plain counts; set one to 0 to
# start a new count).
profile_scatter.launches = 0
profile_scatter_backward.launches = 0
doppler_fill.launches = 0
