"""Per-isotope constants of the line-by-line extinction.

Only the :class:`IsoConst` record of transit_tpu.opacities.lbl is ported
so far; the exact (profile-table) extinction comes with the exact-mode
slice.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class IsoConst:
    """Per-isotope static data."""
    mass: np.ndarray      # (niso,) amu
    ratio: np.ndarray     # (niso,) isotopic abundance ratio
    imol: np.ndarray      # (niso,) molecule index in the atmosphere
    iout: np.ndarray      # (niso,) output-species index (permol mode)
    nmol_out: int         # number of output species
