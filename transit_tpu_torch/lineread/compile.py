"""Line-list compiler: raw databases -> TLI v6 (pylineread equivalent).

Reference: pylineread/src/pylineread.py:133-429.  Assembles per-database
header blocks (partition functions), concatenates transitions with
cumulative isotope offsets, sorts by (isotope, wavelength), and writes the
TLI through transit_tpu_torch.io.tli.
"""

from __future__ import annotations

import argparse
import configparser
import sys

import numpy as np

from transit_tpu_torch import _native
from transit_tpu_torch.io.tli import (TliData, TliDatabase, TliIsotope, write_tli)
from transit_tpu_torch.lineread.base import LineBlock


READERS = {
    "hit": "transit_tpu_torch.lineread.hitran:HitranReader",
    "ps": "transit_tpu_torch.lineread.kurucz:PandsReader",
    "ts": "transit_tpu_torch.lineread.kurucz:TioSchwenkeReader",
    "vo": "transit_tpu_torch.lineread.misc:VoplezReader",
    "repack": "transit_tpu_torch.lineread.misc:RepackReader",
}


def _load_reader(dbtype, dbfile, pffile, defn):
    import importlib
    modname, clsname = READERS[dbtype].split(":")
    cls = getattr(importlib.import_module(modname), clsname)
    if dbtype == "hit":
        from transit_tpu_torch.lineread import tips
        src = None
        if pffile and pffile != "implicit":
            src = tips.transit_pf_source(pffile, 2, 1)
        return cls(dbfile, pf_source=src, defn=defn)
    if dbtype == "repack":
        return cls(dbfile, pffile, defn)
    return cls(dbfile, pffile)


def sort_iso_wl(isoid, wl):
    """Stable argsort by (isotope, wavelength) — the TLI line order
    (pylineread.py:364-383), by the native radix sort
    (:func:`transit_tpu_torch._native.argsort_iso_wl`, compile.py:45-57):
    :func:`sort_iso_wl_plain`'s permutation, in ~O(n)."""
    return _native.argsort_iso_wl(isoid, wl)


def sort_iso_wl_plain(isoid, wl):
    """The plain version of :func:`sort_iso_wl`: numpy's lexsort."""
    return np.lexsort((wl, isoid))


def compile_tli(blocks, iwav: float, fwav: float, output: str):
    """Assemble LineBlocks into one TLI file (pylineread.py:187-425)."""
    # Unique databases (repeats skipped, pylineread.py:215-224):
    dbnames = []
    dbs = []
    acum = []
    total_iso = 0
    for b in blocks:
        if b.name in dbnames:
            continue
        dbnames.append(b.name)
        acum.append(total_iso)
        isotopes = [TliIsotope(n, float(m), float(r), b.pf[k])
                    for k, (n, m, r) in enumerate(
                        zip(b.iso_names, b.iso_mass, b.iso_ratio))]
        dbs.append(TliDatabase(b.name, b.molecule, b.pf_temps, isotopes))
        total_iso += len(isotopes)

    wl = np.concatenate([b.wl for b in blocks])
    gf = np.concatenate([b.gf for b in blocks])
    elow = np.concatenate([b.elow for b in blocks])
    isoid = np.concatenate([
        b.isoid.astype(int) + acum[dbnames.index(b.name)]
        for b in blocks])

    # Sort by isotope then wavelength (pylineread.py:364-383):
    isort = sort_iso_wl(isoid, wl)
    counts = np.bincount(isoid)
    counts = counts[counts > 0]

    data = TliData(version=6, iwav=iwav, fwav=fwav, databases=dbs,
                   wl=wl[isort], isoid=isoid[isort].astype(np.int16),
                   elow=elow[isort], gf=gf[isort],
                   isotran=counts.astype(np.uint64))
    write_tli(output, data)
    return data


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    cp = argparse.ArgumentParser(add_help=False)
    cp.add_argument("-c", "--config_file")
    known, _ = cp.parse_known_args(argv)
    defaults = {}
    if known.config_file:
        config = configparser.ConfigParser()
        config.read([known.config_file])
        defaults = dict(config.items("Parameters"))

    p = argparse.ArgumentParser(
        prog="tli-compile", parents=[cp],
        description="Compile raw line lists into a TLI file.")
    p.add_argument("-o", "--output", default="output.tli")
    p.add_argument("-i", "--iwav", type=float)
    p.add_argument("-f", "--fwav", type=float)
    p.add_argument("-d", "--db_list", nargs="+")
    p.add_argument("-p", "--part_list", nargs="+")
    p.add_argument("-t", "--dbtype", nargs="+")
    p.add_argument("--defn", default=None,
                   help="Isotopologue metadata table (default: bundled).")
    p.add_argument("-v", "--verb", type=int, default=2)
    for k, v in defaults.items():
        if k in ("db_list", "part_list", "dbtype"):
            defaults[k] = v.split()
    p.set_defaults(**defaults)
    args = p.parse_args(argv)

    dbs = args.db_list
    pfs = args.part_list or ["implicit"] * len(dbs)
    types = args.dbtype
    blocks = []
    for dbf, pff, t in zip(dbs, pfs, types):
        reader = _load_reader(t, dbf, pff, args.defn)
        blocks.append(reader.block(float(args.iwav), float(args.fwav)))
    compile_tli(blocks, float(args.iwav), float(args.fwav), args.output)
    print(f"wrote {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
