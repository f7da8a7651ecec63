"""Command-line interface, compatible with the reference transit CLI
(the counterpart of transit_tpu.cli):

    python -m transit_tpu_torch.cli -c run.cfg [--device cpu] [--mode fast]

Reference: transit/src/argum.c (option table), transit.c:233 (main), and the
output writers printmod (slantpath.c:510-555), printflux/printintens
(eclipse.c:293-380), printtoomuch (tau.c:612-640), savetau/saveCIA/
savemolExtion (tau.c:385-518).  Accepts the same config files (-c) and
option names; produces the same file formats.  Runs on the CUDA card
unless ``--device`` (or ``main(device=...)``) names another device; the
model computes in float32 unless ``main(dtype=...)`` says otherwise.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import numpy as np
import torch

from transit_tpu_torch.config import TransitConfig, load_config, _BOOL_FLAGS
from transit_tpu_torch.model import TransitModel
from transit_tpu_torch.opacities.grid import (build_opacity_grid,
                                              build_opacity_grid_fast)
from transit_tpu_torch.utils.log import set_verbosity


def build_parser():
    p = argparse.ArgumentParser(
        prog="transit_tpu_torch",
        description="Transmission/emission spectrum calculator on a CUDA "
                    "card (PyTorch)")
    p.add_argument("-c", "--config_file", action="append", default=[],
                   help="Read options from file (reference .cfg syntax).")
    p.add_argument("--bands", type=int, default=0,
                   help="layer-band count for the fast path (0 = single "
                        "global-halo plan); see opacities/fast.py")
    p.add_argument("--mode", default="exact", choices=["exact", "fast"],
                   help="Extinction path: 'exact' (reference-faithful "
                        "profile table) or 'fast' (on-the-fly Voigt).")
    p.add_argument("--device", default=None,
                   help="torch device to compute on (default: cuda; "
                        "'cpu' runs the kernels' plain versions)")
    for f in dataclasses.fields(TransitConfig):
        name = "--" + f.name
        if f.name in _BOOL_FLAGS:
            p.add_argument(name, action="store_true", default=None)
        elif f.type in ("int", int):
            p.add_argument(name, type=int, default=None)
        elif f.type in ("float", float):
            p.add_argument(name, type=float, default=None)
        else:
            p.add_argument(name, type=str, default=None)
    # Reference aliases (argum.c:574-580 quiet, 127 version):
    p.add_argument("--ethresh", dest="ethreshold", type=float, default=None)
    p.add_argument("--quiet", action="store_true", default=False,
                   help="Set verbosity to the minimum level.")
    from transit_tpu_torch import __version__
    p.add_argument("--version", action="version",
                   version=f"transit_tpu_torch {__version__}")
    return p


def config_from_args(argv):
    cfg, args = _parse(argv)
    return cfg, args.mode, args.bands


def _parse(argv):
    """(the configuration, the parsed arguments) of ``argv``."""
    args = build_parser().parse_args(argv)
    cfg = TransitConfig()
    for path in args.config_file:
        cfg = load_config(path)
    for f in dataclasses.fields(TransitConfig):
        v = getattr(args, f.name, None)
        if v is not None:
            setattr(cfg, f.name, v)
    if args.ethreshold is not None:
        cfg.ethreshold = args.ethreshold
    if args.quiet:
        cfg.verb = 0
    return cfg, args


def _np(x):
    """A tensor (on any device, with or without grad) or an array as a
    numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def write_spectrum(path, wns, spec, solution):
    out = open(path, "w") if path and path != "-" else sys.stdout
    if solution == "eclipse":
        out.write("#wvl [um]      Flux [erg/s/cm]\n")
        for w, s in zip(wns, spec):
            out.write(f"{1e4 / w:<15.10g}{s:<18.9g}\n")
    else:
        out.write("#wvl [um]        modulation\n")
        for w, s in zip(wns, spec):
            out.write(f"{1e4 / w:<17.9g}{s:<18.9g}\n")
    if out is not sys.stdout:
        out.close()


def write_intensity(path, wns, intens, angles):
    """printintens format (eclipse.c:293-349)."""
    if not path or path == "-":
        return
    with open(path, "w") as f:
        f.write("#wvl %*s" % (10, " "))
        for a in angles:
            f.write("I[%4.1f deg]%*s" % (a, 7, " "))
        f.write("\n#[um]%*s" % (10, " "))
        for _ in angles:
            f.write("[erg/s/cm/sr]%*s" % (5, " "))
        f.write("\n")
        for iw, w in enumerate(wns):
            f.write(f"{1e4 / w:<15.10g}")
            for ia in range(len(angles)):
                f.write(f"{intens[ia, iw]:<18.9g}")
            f.write("\n")


def write_toomuch(path, wns, tau, last, rads_v, rfct):
    """printtoomuch format (tau.c:612-640)."""
    if not path:
        return
    with open(path, "w") as f:
        f.write("# Wavelength   Max Optical   Radius at the    Radius\n"
                "   (microns)         depth   max depth (km)    index\n")
        for iw, w in enumerate(wns):
            li = int(last[iw])
            f.write(f"{1e4 / w:12.7f}   {tau[iw, li]:.5e}     "
                    f"{rads_v[li] * rfct / 1e5:12.4f}     {li:04d}\n")


def write_2d(path, header, keys, rows, keytag):
    """print2dArrayDouble format (tau.c:361-382)."""
    with open(path, "w") as f:
        f.write("\n" + header + "\n")
        for k, row in zip(keys, rows):
            f.write(f"{keytag} {k:<20.10g}\n")
            f.write("".join(f"{v:<20.10g}" for v in row) + "\n\n")


def write_2d_stream(path, header, wns, rows):
    """openFile + save1Darray format (tau.c:331-338, 456-467): the
    streamed per-wavenumber dumps put the blank line BEFORE each block
    (save1Darray) rather than after (print2dArrayDouble)."""
    with open(path, "w") as f:
        f.write("\n" + header)
        for w, row in zip(wns, rows):
            f.write(f"\nwavenumber: {w:<20.10g}\n")
            f.write("".join(f"{v:<20.10g}" for v in row) + "\n")


def save_files(res, model):
    """--savefiles outputs (tau.c:179-190, 293-296, 308-329, 385-518):
    tau, CIA, mol-line, and the streamed total/cloud/scatt extinction
    dumps."""
    write_2d("tau.dat",
             "# 2D optical depth\n# tau [wn][rad]; wn[0]=min(wn); "
             "rad[0]=top (min(p))\n",
             res.wns, _np(res.tau), "wavenumber:")
    write_2d("CIA.dat",
             "# 2D CIA extinction\n# e_cs [wn][rad]; wn[0]=min(wn); "
             "row[0]=bottom (max(p))\n",
             res.wns, _np(res.cia), "wavenumber:")
    write_2d("mol_extion.dat",
             "# mol-line extinction\n# e [rad][wn]; rad[0]=bottom "
             "(max(p)); wn[0]=min(wn)\n",
             model.rads_v, _np(res.extinction), "radius:")
    write_2d_stream("total_extion.dat",
                    "# 2D total extinction\n"
                    "# er [wn][rad]; wn[0]=min(wn), row[0]=bottom "
                    "(max(p))\n",
                    res.wns, _np(res.total))
    write_2d_stream("cloud_extion.dat",
                    "# 2D cloud extinction\n"
                    "# e_c [wn][rad]; wn[0]=min(wn), row[0]=bottom "
                    "(max(p))\n",
                    res.wns, _np(res.cloud))
    write_2d_stream("scatt_extion.dat",
                    "# 2D scatt extinction\n"
                    "# e_s [wn][rad]; wn[0]=min(wn), row[0]=bottom "
                    "(max(p))\n",
                    res.wns, _np(res.scatt))


def write_detail(spec, wns, rows_axis, arr, radfirst):
    """--detailext/--detailcia/--detailtau outputs (tau.c:525-605
    detailout): selected-wavenumber columns vs radius rows.

    spec: "filename:wn1,wn2,...".  arr is (nrow, nwn) if radfirst else
    (nwn, nrow).
    """
    fname, wlist = spec.split(":")
    vals = [float(v) for v in wlist.split(",")]
    n = len(wns)
    idx = []
    for v in vals:
        # Reference binary search (tau.c:554-569): largest index with
        # wns[d] <= v, except the top index is only reached on exact
        # equality — a value strictly above the grid bisects to n-2:
        if v == wns[-1]:
            d = n - 1
        else:
            d = int(np.searchsorted(wns, v, side="right") - 1)
            d = min(max(d, 0), n - 2)
        idx.append(d)
    with open(fname, "w") as f:
        f.write("#Radius-w=>    ")
        for i in idx:
            f.write(f"{wns[i]:<15.8g}")
        f.write("\n")
        for m, r in enumerate(rows_axis):
            f.write(f"{r:<15.7g}")
            for i in idx:
                val = arr[m, i] if radfirst else arr[i, m]
                f.write(f"{val:<15.7g}")
            f.write("\n")


def _print_sample(out, name, i, f, d, fct, n, o=None, values=None):
    """One printsample block (makesample.c:641-672)."""
    out.write("############################\n"
              f"   {name:<12} Sampling\n"
              "----------------------------\n")
    out.write(f"Factor to cgs units: {fct:g}\n")
    out.write(f"Initial value: {i:g}\nFinal value: {f:g}\n")
    out.write(f"Spacing: {d:g}\n")
    if o is not None:
        out.write(f"Oversample: {o}\n")
    out.write(f"Number of elements: {n}\n")
    if values is not None:
        out.write("Values: ")
        out.write("".join(" %12.8g" % v for v in values))
        out.write("\n")


def write_sample_info(path, model):
    """outsample report: wavenumber, wavelength, radius, and
    impact-parameter blocks (makesample.c:641-672 printsample, 743-772
    outsample).  The reference never populates tr->wavs (only the hint
    th->wavs; grep makesample.c), so its Wavelength block prints the
    zeroed struct — replicated faithfully.  Radius prints its values
    but no oversample (TRF_NOOVERSAMP); impact parameter prints both
    (makeipsample sets o=0, d=0, i=rads.f, f=rads.i,
    makesample.c:558-575)."""
    if not path:
        return
    out = open(path, "w") if path != "-" else sys.stdout
    w = model.wns
    _print_sample(out, "Wavenumber", w.i, w.f, w.d, w.fct, w.n, o=w.o)
    _print_sample(out, "Wavelength", 0, 0, 0, 0, 0, o=0)
    rv = model.rads_v
    rd = model.cfg.raddelt if model._atm0 is not None else 0.0
    _print_sample(out, "Radius", rv[0], rv[-1], rd, model.rfct,
                  len(rv), values=rv)
    ips = model.ips_v
    _print_sample(out, "Impact parameter", rv[-1], rv[0], 0.0,
                  model.rfct, len(ips), o=0, values=ips)
    if out is not sys.stdout:
        out.close()


def main(argv=None, device=None, dtype=None):
    """Run the CLI on ``argv`` (default sys.argv[1:]); ``device`` and
    ``dtype`` go to the models (``device`` overrides ``--device``).
    Returns the exit code."""
    cfg, args = _parse(sys.argv[1:] if argv is None else argv)
    mode, bands = args.mode, args.bands
    device = device if device is not None else args.device
    set_verbosity(cfg.verb)

    if cfg.justOpacity or (cfg.opacityfile and
                           not os.path.exists(cfg.opacityfile)):
        # Reference opacity modes (opacity.c:39-70): --justOpacity stops
        # after the build; a specified-but-absent opacityfile (mode b)
        # computes the grid, writes it, and CONTINUES to the spectrum in
        # the same run — the model below then reads the fresh grid and
        # serves the spectrum by T-interpolation (extinction.c:534-581),
        # exactly like a pre-existing-grid (mode c) invocation.
        build_model = TransitModel(cfg, mode=mode, bands=bands,
                                   device=device, dtype=dtype)
        if mode == "fast":
            build_opacity_grid_fast(build_model, cfg.opacityfile)
        else:
            build_opacity_grid(build_model, cfg.opacityfile)
        if cfg.justOpacity:
            return 0
        del build_model

    model = TransitModel(cfg, mode=mode, bands=bands, device=device,
                         dtype=dtype)
    res = model.compute()

    write_spectrum(cfg.outspec, res.wns, _np(res.spectrum), model.solution)
    if model.solution == "eclipse" and res.intensity is not None:
        write_intensity(cfg.outintens, res.wns, _np(res.intensity),
                        model.angles)
    if cfg.outtoomuch:
        write_toomuch(cfg.outtoomuch, res.wns, _np(res.tau), _np(res.last),
                      model.rads_v, model.rfct)
    if cfg.outsample:
        write_sample_info(cfg.outsample, model)
    if cfg.savefiles:
        save_files(res, model)
    if cfg.detailext:
        write_detail(cfg.detailext, res.wns, model.rads_v,
                     _np(res.extinction), radfirst=True)
    if cfg.detailcia:
        write_detail(cfg.detailcia, res.wns, model.rads_v,
                     _np(res.cia), radfirst=False)
    if cfg.detailtau:
        write_detail(cfg.detailtau, res.wns, model.ips_v,
                     _np(res.tau), radfirst=False)
    return 0


if __name__ == "__main__":
    sys.exit(main())
