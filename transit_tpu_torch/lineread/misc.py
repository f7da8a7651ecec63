"""Plez VO (ASCII) and repack (ExoMol-scale compressed) readers.

Reference: pylineread/src/db_voplez.py and db_repack.py.
"""

from __future__ import annotations

import os

import numpy as np

from transit_tpu_torch.lineread.base import DbReader, MTC, load_isotopologues
from transit_tpu_torch.lineread import tips


class VoplezReader(DbReader):
    """B. Plez VO line list: 53-char fixed-width ASCII records with gf at
    [21:32], wavenumber at [33:43], Elow at [44:50]."""
    name = "Bertrand Plez VO"
    molecule = "VO"
    iso_names = ["16"]
    iso_mass = np.array([66.941])
    iso_ratio = np.array([1.0])
    # Irwin (1981)-style partition polynomial (db_voplez.py:37-40):
    PFcoeffs = np.array([6.62090157e+02, -4.03350494e+02, 9.82836218e+01,
                         -1.18526504e+01, 7.08429905e-01, -1.67235124e-02])

    def __init__(self, dbfile: str, pffile: str = None):
        self.dbfile = dbfile
        self.recsize = 53

    def read(self, iwl: float, fwl: float):
        with open(self.dbfile, "rb") as f:
            raw = f.read()
        n = len(raw) // self.recsize
        lines = [raw[i * self.recsize:(i + 1) * self.recsize].decode("ascii")
                 for i in range(n)]
        wn = np.array([float(s[33:43]) for s in lines])
        gf = np.array([float(s[21:32]) for s in lines])
        elow = np.array([float(s[44:50]) for s in lines])
        wl = 1.0 / (wn * MTC)
        keep = (wl >= iwl) & (wl <= fwl)
        return (wl[keep], gf[keep], elow[keep],
                np.zeros(int(keep.sum()), np.int16))

    def partition(self):
        return tips.polynomial_source(self.PFcoeffs)(self.iso_names)


class RepackReader(DbReader):
    """repack (Cubillos 2017) compressed ExoMol line lists: 28-byte binary
    records <f8 wavenumber(cm-1), f8 Elow, f8 gf, i4 isotope-code>, sorted
    by wavenumber; the partition-function file names the isotopes.

    This is the route for 1e9-line databases: the reader memory-maps the
    file and clips by wavenumber window without loading the whole list.
    """

    def __init__(self, dbfile: str, pffile: str, defn: str = None):
        self.dbfile = dbfile
        self.pffile = pffile
        base = os.path.split(dbfile)[1].split("_")
        self.molecule = base[0]
        self.name = "repack " + self.molecule
        with open(pffile) as f:
            f.readline()
            self.iso_names = f.readline().split()[1:]
        meta = {r["exomol_iso"]: r for r in load_isotopologues(defn)
                if r["molecule"] == self.molecule}
        self.iso_mass = np.array([meta[i]["mass"] if i in meta else 0.0
                                  for i in self.iso_names])
        self.iso_ratio = np.array([meta[i]["ratio"] if i in meta else 1.0
                                   for i in self.iso_names])
        self._code_to_idx = {int(i): k for k, i in
                             enumerate(self.iso_names)}

    def read(self, iwl: float, fwl: float):
        rec = np.memmap(self.dbfile, dtype=np.dtype(
            [("wn", "<f8"), ("elow", "<f8"), ("gf", "<f8"),
             ("iso", "<i4")]), mode="r")
        iwn = 1.0 / (fwl * MTC)
        fwn = 1.0 / (iwl * MTC)
        # Records are sorted by wavenumber — binary search the window.
        # bisect_mm, not np.searchsorted: rec["wn"] is a STRIDED view of
        # the memmap, which searchsorted would copy wholesale (the full
        # wn column of a multi-GB repack file) on every call:
        from transit_tpu_torch.io.tli import bisect_mm
        lo = bisect_mm(rec["wn"], iwn, side="left")
        hi = bisect_mm(rec["wn"], fwn, side="right")
        r = rec[lo:hi]
        wl = 1e4 / r["wn"]
        isoid = np.array([self._code_to_idx[int(i)] for i in r["iso"]],
                         dtype=np.int16)
        return wl.astype(np.float64), r["gf"].astype(np.float64), \
            r["elow"].astype(np.float64), isoid

    def partition(self):
        # Two header lines, then rows "T pf1 pf2 ..." (db_repack.py:115-139):
        with open(self.pffile) as f:
            lines = [ln for ln in f.read().splitlines()][2:]
        lines = [ln for ln in lines if ln.strip()]
        data = np.array([[float(v) for v in ln.split()] for ln in lines])
        return data[:, 0], data[:, 1:].T.copy()
