"""Atmosphere-file parsing and molecular metadata.

Reference: transit/src/readatm.c (keyword header + layer table, ideal-gas
densities, bottom-up sort enforcement) and getmoldata (readatm.c:625-717).
All host-side numpy; the parsed structure feeds device arrays.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from transit_tpu_torch.constants import AMU, KB, ANGSTROM


@dataclasses.dataclass
class MoleculeInfo:
    """Per-species static data from molecules.dat (readatm.c:625-717)."""
    names: list
    ids: np.ndarray       # universal molecule IDs
    mass: np.ndarray      # g/mol
    radius: np.ndarray    # collision radius, cm (file diameter/2 * Angstrom)
    pol: np.ndarray       # polarizability, Angstrom^3


@dataclasses.dataclass
class Atmosphere:
    """Parsed atmosphere: bottom-up sorted layers."""
    species: list          # species names, file order
    radius: np.ndarray     # (nl,) in file units
    rfct: float            # radius units factor to cm ('ur' keyword)
    press: np.ndarray      # (nl,) in file units
    pfct: float            # pressure units factor ('up')
    temp: np.ndarray       # (nl,) in file units
    tfct: float            # temperature units factor ('ut')
    q: np.ndarray          # (nmol, nl) abundances
    by_mass: bool          # abundances by mass ('q m') vs number ('q n')
    mm: np.ndarray = None  # (nl,) mean molecular mass, amu
    d: np.ndarray = None   # (nmol, nl) densities, g/cm3
    info: str = ""

    @property
    def nlayers(self):
        return self.radius.shape[0]


def read_molecules(path: str) -> MoleculeInfo:
    names, ids, mass, radius, pol = [], [], [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            fields = line.split()
            ids.append(int(fields[0]))
            names.append(fields[1])
            mass.append(float(fields[2]))
            radius.append(float(fields[3]) / 2.0)  # diameter -> radius
            # fields[4] is the radius source tag; fields[5] polarizability
            pol.append(float(fields[5]))
    return MoleculeInfo(names=names, ids=np.array(ids, dtype=np.int32),
                        mass=np.array(mass), radius=np.array(radius),
                        pol=np.array(pol))


def molecule_subset(info: MoleculeInfo, species: list) -> MoleculeInfo:
    """Rows of molecules.dat for the atmosphere's species, in atm order,
    with units applied as the reference does (readatm.c:697-716)."""
    idx = []
    for s in species:
        if s not in info.names:
            raise ValueError(f"species {s!r} not in molecules file")
        idx.append(info.names.index(s))
    idx = np.array(idx)
    return MoleculeInfo(names=list(species), ids=info.ids[idx],
                        mass=info.mass[idx],
                        radius=info.radius[idx] * ANGSTROM,
                        pol=info.pol[idx])


def state_eqn_density(by_mass, q, mm, mi, p, t):
    """Ideal-gas density of one species (transit.h:57-69 stateeqnford).

    p in cgs (barye), t in K; returns g/cm3."""
    rho = AMU * q * p / KB / t
    return rho * np.where(by_mass, mm, mi)


def mean_molar_mass(q, mass, by_mass):
    """checkaddmm (readatm.c:122-159): mm per layer plus abundance sum."""
    q = np.asarray(q)             # (nmol, nl)
    mass = np.asarray(mass)[:, None]
    if by_mass:
        mm = 1.0 / np.sum(q / mass, axis=0)
    else:
        mm = np.sum(q * mass, axis=0)
    sumq = np.sum(q, axis=0)
    return mm, sumq


def read_atmosphere(path: str, molfile: str = None,
                    qmol=None, qscale=None, allowq: float = 1e-5
                    ) -> tuple:
    """Parse an atmosphere file; returns (Atmosphere, MoleculeInfo-subset).

    Reproduces readatm.c: keyword headers (q/z/u*/#SPECIES), layer table,
    optional log10 abundance scaling of qmol species with H2/He rebalancing
    (readatm.c:519-541), mean molecular mass, ideal-gas densities, and
    bottom-up sorting (readatm.c:583-617).
    """
    by_mass = False
    zerorad = 0.0
    rfct = 1.0
    pfct = 1.0
    tfct = 1.0
    species = None
    info_str = ""
    rows = []

    with open(path) as f:
        lines = f.readlines()

    i = 0
    n = len(lines)
    while i < n:
        line = lines[i].rstrip("\n")
        i += 1
        s = line.strip()
        if not s:
            continue
        if s.startswith("#"):
            key = s[1:].split()[0] if s[1:].split() else ""
            if key == "SPECIES":
                species = lines[i].split()
                i += 1
            continue
        c = s[0]
        if c == "q":
            mode = s[1:].strip()[:1].lower()
            if mode == "m":
                by_mass = True
            elif mode == "n":
                by_mass = False
            else:
                raise ValueError(f"bad q option: {line!r}")
        elif c == "z":
            zerorad = float(s[1:])
        elif c == "u":
            sub = s[1]
            val = float(s[2:])
            if sub == "r":
                rfct = val
            elif sub == "p":
                pfct = val
            elif sub == "t":
                tfct = val
            else:
                raise ValueError(f"bad unit keyword: {line!r}")
        elif c == "n":
            info_str = s[1:].strip()
        else:
            # First data row reached:
            i -= 1
            break

    if species is None:
        raise ValueError(f"{path}: no #SPECIES header")
    nmol = len(species)

    for j in range(i, n):
        s = lines[j].strip()
        if not s or s.startswith("#"):
            continue
        vals = [float(v) for v in s.split()]
        if len(vals) != 3 + nmol:
            raise ValueError(f"{path}: row has {len(vals)} fields, "
                             f"expected {3 + nmol}")
        rows.append(vals)

    arr = np.array(rows, dtype=np.float64)
    radius = arr[:, 0] + zerorad
    press = arr[:, 1]
    temp = arr[:, 2]
    q = arr[:, 3:].T.copy()      # (nmol, nl)

    molinfo = None
    if molfile is not None:
        molinfo = molecule_subset(read_molecules(molfile), species)

    # Abundance scale factors (readatm.c:394-407,519-541):
    if qmol:
        if molinfo is None:
            raise ValueError("qmol scaling requires a molecules file")
        iH2 = _index_of_id(molinfo.ids, 105)
        iHe = _index_of_id(molinfo.ids, 2)
        for name, scale in zip(qmol, qscale):
            k = species.index(name)
            q[k] *= 10.0 ** scale
        sumq2 = np.zeros(q.shape[1])
        for k in range(nmol):
            if k != iH2 and k != iHe:
                sumq2 += q[k]
        ratio = q[iH2] / q[iHe]
        q[iHe] = (1.0 - sumq2) / (1.0 + ratio)
        q[iH2] = ratio * (1.0 - sumq2) / (1.0 + ratio)

    mm, sumq = mean_molar_mass(q, molinfo.mass if molinfo else np.ones(nmol),
                               by_mass)

    # Bottom-up sort check (readatm.c:583-617):
    nl = radius.shape[0]
    sorted_up = np.all(np.diff(radius) > 0) and np.all(np.diff(press) < 0)
    reversed_dn = np.all(np.diff(radius) < 0) and np.all(np.diff(press) > 0)
    if not sorted_up and not reversed_dn:
        raise ValueError(f"{path}: layers are neither bottom-up nor "
                         "top-down sorted")
    if reversed_dn:
        radius = radius[::-1].copy()
        press = press[::-1].copy()
        temp = temp[::-1].copy()
        mm = mm[::-1].copy()
        q = q[:, ::-1].copy()

    atm = Atmosphere(species=species, radius=radius, rfct=rfct,
                     press=press, pfct=pfct, temp=temp, tfct=tfct,
                     q=q, by_mass=by_mass, mm=mm, info=info_str)
    if molinfo is not None:
        atm.d = state_eqn_density(by_mass, q, mm[None, :],
                                  molinfo.mass[:, None],
                                  press[None, :] * pfct,
                                  temp[None, :] * tfct)
    return atm, molinfo


def _index_of_id(ids, mid):
    w = np.where(ids == mid)[0]
    return int(w[0]) if w.size else -1
