"""Cross-section (CIA) table files.

Reference: transit/src/crosssec.c.  ASCII format:
    # comments
    i <species1> [species2]
    t <T1> <T2> ... <Tn>
    <wn>  <cs(T1)> ... <cs(Tn)>      (one row per wavenumber, cm-1 amagat-2)
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class CrossSection:
    species: list         # 1 or 2 species names
    temps: np.ndarray     # (nt,)
    wn: np.ndarray        # (nw,)
    cs: np.ndarray        # (nw, nt) cross sections, cm-1 amagat^-nspec


def read_cross_section(path: str) -> CrossSection:
    species = None
    temps = None
    rows = []
    wns = []
    with open(path) as f:
        for line in f:
            s = line.strip()
            if not s or s.startswith("#"):
                continue
            if s[0] == "i":
                species = s[1:].split()
                if len(species) not in (1, 2):
                    raise ValueError(f"{path}: 'i' line must list 1 or 2 "
                                     f"species: {s!r}")
                continue
            if s[0] == "t" and temps is None:
                toks = [t.rstrip("kK") for t in s[1:].split()]
                temps = np.array([float(t) for t in toks])
                continue
            vals = s.split()
            wns.append(float(vals[0]))
            rows.append([float(v) for v in vals[1:]])
    if species is None or temps is None:
        raise ValueError(f"{path}: missing 'i' or 't' header line")
    cs = np.array(rows, dtype=np.float64)
    if cs.shape[1] != temps.shape[0]:
        raise ValueError(f"{path}: {cs.shape[1]} columns but "
                         f"{temps.shape[0]} temperatures")
    return CrossSection(species=species, temps=temps,
                        wn=np.array(wns), cs=cs)
