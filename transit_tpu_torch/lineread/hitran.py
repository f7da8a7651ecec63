"""HITRAN / HITEMP .par fixed-width line-list reader.

Reference: pylineread/src/db_hitran.py.  160-character records; the fields
used are isotope ID [2:3], wavenumber [3:15], Einstein A [25:35], lower-state
energy [45:55], and lower statistical weight [155:160].  gf comes from the
Einstein A coefficient (db_hitran.py:388):

    gf = A21 * g2 * C1 / (8 pi c) / nu^2,   C1 = 4 eps0 me c^2 / e^2 (cgs-cm)

Partition functions are pluggable (see lineread/tips.py) since the
reference's TIPS C submodule is not vendored.
"""

from __future__ import annotations

import numpy as np

from transit_tpu_torch import _native
from transit_tpu_torch.lineread.base import DbReader, MTC, load_isotopologues
from transit_tpu_torch.lineread import tips

# C1 = 4*eps0*me*c^2/e^2 * 0.01 (pylineread constants.py:19): in cm-1
_EPS0 = 8.8541878128e-12
_ME = 9.1093837015e-31
_C = 299792458.0
_E = 1.602176634e-19
C1 = 4.0 * _EPS0 * _ME * _C ** 2 / _E ** 2 * 0.01
C2 = 6.62607015e-34 * _C / 1.380649e-23 * 100.0


class HitranReader(DbReader):
    def __init__(self, dbfile: str, pf_source=None, defn: str = None):
        self.dbfile = dbfile
        with open(dbfile, "rb") as f:
            first = f.readline()
        self.recsize = len(first)            # includes newline
        self.mol_id = int(first[:2])
        meta = [r for r in load_isotopologues(defn)
                if r["mol_id"] == self.mol_id]
        if not meta:
            raise ValueError(f"molecule ID {self.mol_id} not in "
                             "isotopologue table")
        self.molecule = meta[0]["molecule"]
        self.name = f"hitran-{self.molecule}"
        self.iso_names = [r["hitran_iso"] for r in meta]
        self.iso_mass = np.array([r["mass"] for r in meta])
        self.iso_ratio = np.array([r["ratio"] for r in meta])
        self.gi = np.array([r["gi"] for r in meta])
        self.pf_source = pf_source or tips.default_source(self.molecule,
                                                          self.iso_names)

    # Records per streamed chunk: 2M records x 160 B = ~320 MB resident,
    # independent of file size (HITEMP H2O is ~10 GB):
    CHUNK_RECORDS = 2_000_000

    def _record_bounds(self, f, iwn: float, fwn: float):
        """Binary search the (wavenumber-sorted) fixed-width records for
        the window [iwn, fwn] — the streamed analogue of the reference's
        in-file search (pylineread/src/driver.py:39-118)."""
        f.seek(0, 2)
        nrec = f.tell() // self.recsize

        def wn_at(i):
            f.seek(i * self.recsize + 3)
            return float(f.read(12).decode("ascii"))

        def lower_bound(target):
            lo, hi = 0, nrec
            while lo < hi:
                mid = (lo + hi) // 2
                if wn_at(mid) < target:
                    lo = mid + 1
                else:
                    hi = mid
            return lo

        return lower_bound(iwn), lower_bound(np.nextafter(fwn, np.inf)), \
            nrec

    def read(self, iwl: float, fwl: float):
        iwn = 1.0 / (fwl * MTC)
        fwn = 1.0 / (iwl * MTC)
        parts = []
        with open(self.dbfile, "rb") as f:
            lo, hi, _ = self._record_bounds(f, iwn, fwn)
            for c0 in range(lo, hi, self.CHUNK_RECORDS):
                c1 = min(c0 + self.CHUNK_RECORDS, hi)
                f.seek(c0 * self.recsize)
                raw = f.read((c1 - c0) * self.recsize)
                parts.append(self._parse_records(raw, iwn, fwn))
        if not parts:
            z = np.zeros(0)
            return z, z.copy(), z.copy(), np.zeros(0, np.int16)
        wl = np.concatenate([p[0] for p in parts])
        gf = np.concatenate([p[1] for p in parts])
        elow = np.concatenate([p[2] for p in parts])
        isoid = np.concatenate([p[3] for p in parts])
        return wl, gf, elow, isoid

    def _parse_records(self, raw: bytes, iwn: float, fwn: float):
        n = len(raw) // self.recsize
        rec = np.frombuffer(raw[:n * self.recsize],
                            dtype=np.uint8).reshape(n, self.recsize)

        # Vectorized fixed-width float parse:
        wn = _parse_float(rec[:, 3:15])
        keep = (wn >= iwn) & (wn <= fwn)
        idx = np.where(keep)[0]
        rec = rec[idx]
        wn = wn[idx]

        iso_char = rec[:, 2:3]
        isoid = _parse_float(iso_char).astype(int)
        isoid -= 1
        isoid[isoid < 0] = 9       # '0' encodes the 10th isotope
        a21 = _parse_float(rec[:, 25:35])
        elow = _parse_float(rec[:, 45:55])
        g2 = _parse_float(rec[:, 155:self.recsize])

        gf = a21 * g2 * C1 / (8.0 * np.pi * _C * 100.0) / wn ** 2
        wl = 1.0 / (wn * MTC)
        return wl, gf, elow, isoid.astype(np.int16)

    def partition(self):
        return self.pf_source(self.iso_names)


def _parse_float(rec: np.ndarray) -> np.ndarray:
    """Parse a fixed-width ASCII float column (2-D uint8 array) with the
    native parser (:func:`transit_tpu_torch._native.parse_fixed_floats`,
    hitran.py:127-135): C's strtod in the C locale, so a blank field is
    0.0, where :func:`_parse_float_plain` raises."""
    w = rec.shape[1]
    return _native.parse_fixed_floats(np.ascontiguousarray(rec).tobytes(), w,
                                      0, w, rec.shape[0])


def _parse_float_plain(rec: np.ndarray) -> np.ndarray:
    """The plain version of :func:`_parse_float`: Python's float() of
    each field (an empty field 0; a blank one raises ValueError)."""
    s = rec.tobytes().decode("ascii")
    w = rec.shape[1]
    return np.array([float(s[i * w:(i + 1) * w] or 0)
                     for i in range(rec.shape[0])])
