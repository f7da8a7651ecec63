"""Kurucz-style binary line lists: Partridge & Schwenke H2O, Schwenke TiO.

Reference: pylineread/src/db_pands.py and db_tioschwenke.py.

P&S (h2ofastfix.bin): 8-byte records <u4, i2, i2> = (log-wavelength index,
  +-Elow, +-gf-index).  wavelength = exp(iw * log(1 + 1/2e6)) nm;
  gf = 4*10^(0.001*(|igf|-16384)); elow = |ielo|; the two sign bits encode
  the isotope: iso = 2*(ielo<0) + (igf<0).

Schwenke TiO (tioschwenke.bin): 16-byte records, first 10 bytes
  <i4, i2, i2, i2> = (log-wavelength index, +-iso code, elow index,
  gf index); gf and elow via 10^(0.001*(i-16384)); iso = |ieli| - 8950.
"""

from __future__ import annotations

import numpy as np

from transit_tpu_torch.lineread.base import DbReader, MTC, NTC
from transit_tpu_torch.lineread import tips

_RATIOLOG = np.log(1.0 + 1.0 / 2e6)


class PandsReader(DbReader):
    name = "Partridge & Schwenke (1997)"
    molecule = "H2O"
    iso_names = ["1H1H16O", "1H1H17O", "1H1H18O", "1H2H16O"]
    iso_mass = np.array([18.01056468, 19.01478156, 20.01481046, 19.01684143])
    iso_ratio = np.array([0.997000, 0.000508, 0.000508, 0.001984])

    def __init__(self, dbfile: str, pffile: str = None):
        self.dbfile = dbfile
        self.pffile = pffile
        self.tablog = 4.0 * 10.0 ** (0.001 * (np.arange(32769) - 16384))

    def read(self, iwl: float, fwl: float):
        rec = np.fromfile(self.dbfile,
                          dtype=np.dtype([("iw", "<u4"), ("ielo", "<i2"),
                                          ("igf", "<i2")]))
        wl_nm = np.exp(rec["iw"] * _RATIOLOG)     # nanometers
        keep = (wl_nm >= iwl * MTC / NTC) & (wl_nm <= fwl * MTC / NTC)
        rec = rec[keep]
        wl = np.exp(rec["iw"] * _RATIOLOG) * NTC / MTC     # microns
        gf = self.tablog[np.abs(rec["igf"])]
        elow = np.abs(rec["ielo"]).astype(np.float64)
        isoid = (2 * (rec["ielo"] < 0) + 1 * (rec["igf"] < 0)).astype(
            np.int16)
        return wl, gf, elow, isoid

    def partition(self):
        # h2opartfn.dat layout (db_pands.py:45-46):
        return tips.transit_pf_source(self.pffile, 6, 3)(self.iso_names)


class TioSchwenkeReader(DbReader):
    name = "Schwenke TiO (1998)"
    molecule = "TiO"
    iso_names = ["46", "47", "48", "49", "50"]
    iso_mass = np.array([61.94754403, 62.94667863, 63.94286193,
                         64.94278573, 65.93970673])
    iso_ratio = np.array([0.080, 0.073, 0.738, 0.055, 0.054])

    def __init__(self, dbfile: str, pffile: str = None):
        self.dbfile = dbfile
        self.pffile = pffile
        self.tablog = 10.0 ** (0.001 * (np.arange(32769) - 16384))

    def read(self, iwl: float, fwl: float):
        raw = np.fromfile(self.dbfile, dtype=np.uint8)
        n = raw.shape[0] // 16
        rec = raw[:n * 16].reshape(n, 16)[:, :10].copy()
        r = np.frombuffer(rec.tobytes(),
                          dtype=np.dtype([("iw", "<i4"), ("ieli", "<i2"),
                                          ("ielo", "<i2"), ("igf", "<i2")]))
        wl_nm = np.exp(r["iw"] * _RATIOLOG)
        keep = (wl_nm >= iwl * MTC / NTC) & (wl_nm <= fwl * MTC / NTC)
        r = r[keep]
        wl = np.exp(r["iw"] * _RATIOLOG) * NTC / MTC
        gf = self.tablog[r["igf"]]
        elow = self.tablog[r["ielo"]]
        isoid = (np.abs(r["ieli"]) - 8950).astype(np.int16)
        return wl, gf, elow, isoid

    def partition(self):
        # tiopart.dat layout (db_tioschwenke.py:28-29):
        return tips.transit_pf_source(self.pffile, 1, 0)(self.iso_names)
