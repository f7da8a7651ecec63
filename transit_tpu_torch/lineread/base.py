"""Line-list database readers: common interface.

Reference: pylineread/src/driver.py (dbdriver).  Each reader loads a raw
database format, clips to a wavelength window, and yields TLI-ready arrays.
Readers here are numpy-vectorized (bulk reads + searchsorted) instead of the
reference's per-record file seeks.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

MTC = 1e-4   # microns -> cm
NTC = 1e-7   # nanometers -> cm


@dataclasses.dataclass
class LineBlock:
    """One database's contribution to a TLI file."""
    name: str               # database name
    molecule: str           # molecule name
    iso_names: list         # isotope names
    iso_mass: np.ndarray    # amu
    iso_ratio: np.ndarray
    pf_temps: np.ndarray    # (nT,)
    pf: np.ndarray          # (niso, nT)
    wl: np.ndarray          # (N,) microns
    gf: np.ndarray
    elow: np.ndarray        # cm-1
    isoid: np.ndarray       # (N,) local isotope index (0-based)


class DbReader:
    """Interface: subclasses set metadata and implement read(iwl, fwl) ->
    (wl_um, gf, elow, isoid) and partition() -> (temps, pf)."""
    name = "unnamed"
    molecule = "?"
    iso_names: list = []
    iso_mass: np.ndarray = None
    iso_ratio: np.ndarray = None

    def read(self, iwl: float, fwl: float):
        raise NotImplementedError

    def partition(self):
        raise NotImplementedError

    def block(self, iwl: float, fwl: float) -> LineBlock:
        wl, gf, elow, isoid = self.read(iwl, fwl)
        temps, pf = self.partition()
        return LineBlock(name=self.name, molecule=self.molecule,
                         iso_names=list(self.iso_names),
                         iso_mass=np.asarray(self.iso_mass, float),
                         iso_ratio=np.asarray(self.iso_ratio, float),
                         pf_temps=np.asarray(temps, float),
                         pf=np.asarray(pf, float),
                         wl=wl, gf=gf, elow=elow,
                         isoid=np.asarray(isoid, np.int16))


def read_pf_file(path: str, skip_header: int, isonames_line: int):
    """Text partition-function table: isotope names on one header line,
    then rows of T pf1 pf2 ... (db_pands.py pf_ignore/pf_isonames)."""
    with open(path) as f:
        lines = [ln for ln in f.read().splitlines() if ln.strip()]
    isonames = lines[isonames_line].split()[1:]
    body = lines[skip_header:]
    data = np.array([[float(v) for v in ln.split()] for ln in body])
    return isonames, data[:, 0], data[:, 1:].T.copy()


def load_isotopologues(path: str = None):
    """Bundled isotopologue metadata (lineread/data/isotopologues.csv), or a
    user-supplied file in either this CSV format or the reference's
    whitespace table (pylineread/inputs/isotopologues.dat)."""
    if path is None:
        path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "data", "isotopologues.csv")
    rows = []
    with open(path) as f:
        for line in f:
            s = line.strip()
            if not s or s.startswith("#"):
                continue
            fields = s.split(",") if "," in s else s.split()
            rows.append(dict(
                mol_id=int(fields[0]), molecule=fields[1],
                hitran_iso=fields[2], exomol_iso=fields[3],
                gi=int(fields[4]), ratio=float(fields[5]),
                mass=float(fields[6])))
    return rows
