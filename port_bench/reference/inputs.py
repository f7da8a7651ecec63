"""Readers of the input files and the static problem of a configuration.

Plain numpy: the TLI v6 line list (little-endian, each isotope's lines
sorted by wavelength), the atmosphere file (keyword header, `#SPECIES`,
one row a layer), molecules.dat and the CIA tables, read as the reference
C code reads them.  :func:`load_problem` turns a benchmark configuration
(``port_bench/configs/<name>.json``) and its line list into the host
arrays the reference model works from.
"""

from __future__ import annotations

import dataclasses
import struct
from pathlib import Path

import numpy as np

from .constants import AMU, ANGSTROM, KB, TLI_WAV_UNITS

_MAGIC = b"\xff\xb6\xb3\xab"


@dataclasses.dataclass
class LineList:
    """A TLI file: per isotope (name, molecule, mass, ratio), the
    partition-function tables (temps (niso, nT), z (niso, nT)), and the
    lines in file order (wl in microns, isoid, elow in cm-1, gf)."""
    iso_name: list
    iso_mol: list
    iso_mass: np.ndarray
    iso_ratio: np.ndarray
    pf_temps: list
    pf_z: list
    wl: np.ndarray
    isoid: np.ndarray
    elow: np.ndarray
    gf: np.ndarray
    header: bytes = b""      # everything before the line count


def read_tli(path) -> LineList:
    raw = Path(path).read_bytes()
    if raw[:4] != _MAGIC:
        raise ValueError(f"{path}: not a little-endian TLI file")
    off = 4

    def take(fmt):
        nonlocal off
        vals = struct.unpack_from("<" + fmt, raw, off)
        off += struct.calcsize("<" + fmt)
        return vals

    def text():
        nonlocal off
        (n,) = take("H")
        s = raw[off:off + n].decode("ascii")
        off += n
        return s

    version, _, _ = take("3H")
    if version != 6:
        raise ValueError(f"{path}: TLI version {version}, not 6")
    take("2d")
    (ndb,) = take("H")
    names, mols, mass, ratio, temps, zs = [], [], [], [], [], []
    for _ in range(ndb):
        text()
        mol = text()
        nt, niso = take("2H")
        t = np.frombuffer(raw, "<f8", nt, off).copy()
        off += 8 * nt
        for _ in range(niso):
            names.append(text())
            m, r = take("2d")
            z = np.frombuffer(raw, "<f8", nt, off).copy()
            off += 8 * nt
            mols.append(mol)
            mass.append(m)
            ratio.append(r)
            temps.append(t)
            zs.append(z)
    header = raw[:off]
    (n,) = take("Q")
    (niso_lines,) = take("i")
    off += 8 * niso_lines
    wl = np.frombuffer(raw, "<f8", n, off).copy()
    off += 8 * n
    isoid = np.frombuffer(raw, "<i2", n, off).astype(np.int64)
    off += 2 * n
    elow = np.frombuffer(raw, "<f8", n, off).copy()
    off += 8 * n
    gf = np.frombuffer(raw, "<f8", n, off).copy()
    return LineList(names, mols, np.array(mass), np.array(ratio), temps, zs,
                    wl, isoid, elow, gf, header)


def write_tli(path, src: LineList, wl, isoid, elow, gf) -> None:
    """Lines (already sorted by isotope, then wavelength) as a TLI file
    with ``src``'s header (databases, isotopes, partition functions)."""
    isoid = np.asarray(isoid, dtype="<i2")
    counts = np.bincount(isoid)
    counts = counts[counts > 0].astype("<u8")
    with open(path, "wb") as f:
        f.write(src.header)
        f.write(struct.pack("<Q", wl.shape[0]))
        f.write(struct.pack("<i", counts.shape[0]))
        f.write(counts.tobytes())
        for a, dt in ((wl, "<f8"), (isoid, "<i2"), (elow, "<f8"),
                      (gf, "<f8")):
            np.asarray(a, dtype=dt).tofile(f)


def select_lines(tli: LineList, wn_low: float, wn_high: float):
    """The lines whose wavelength lies in [1/wn_high, 1/wn_low] (file
    order kept): (wl, isoid, elow, gf)."""
    lo = 1.0 / wn_high / TLI_WAV_UNITS
    hi = 1.0 / wn_low / TLI_WAV_UNITS
    k = (tli.wl >= lo) & (tli.wl <= hi)
    return tli.wl[k], tli.isoid[k], tli.elow[k], tli.gf[k]


def split_lines(tli: LineList, wn_low: float, wn_high: float, copies: int,
                jitter: float, seed: int):
    """The in-range lines split ``copies`` ways (a list as long as an
    ExoMol molecule's, made from a small one): each copy keeps its
    line's isotope and elow, takes gf / copies, and draws its wavenumber
    uniformly within +-``jitter`` cm-1 of the line's (numpy, seeded).  Returned sorted by isotope, then
    wavelength, as a TLI holds them: (wl, isoid, elow, gf)."""
    wl0, iso0, el0, gf0 = select_lines(tli, wn_low, wn_high)
    rng = np.random.default_rng(seed)
    wn = rng.uniform(-jitter, jitter, wl0.shape[0] * copies)
    wn += np.repeat(1.0 / (wl0 * TLI_WAV_UNITS), copies)
    wl = 1.0 / (wn * TLI_WAV_UNITS)
    iso = np.repeat(iso0, copies)
    order = np.lexsort((wl, iso))
    return (wl[order], iso[order], np.repeat(el0, copies)[order],
            np.repeat(gf0 / copies, copies)[order])


@dataclasses.dataclass
class Atmosphere:
    species: list
    radius: np.ndarray       # (nl,) file units, bottom up
    rfct: float
    press: np.ndarray        # (nl,) file units
    pfct: float
    temp: np.ndarray         # (nl,) K
    q: np.ndarray            # (nmol, nl) number fractions
    mol_mass: np.ndarray     # (nmol,) amu
    mol_radius: np.ndarray   # (nmol,) cm


def read_atmosphere(path, molfile) -> Atmosphere:
    """An atmosphere file with number abundances ('q number') and units
    'ur', 'up' (temperatures in K), layers bottom up or top down."""
    rfct = pfct = 1.0
    species, rows = None, []
    lines = Path(path).read_text().splitlines()
    i = 0
    while i < len(lines):
        s = lines[i].strip()
        i += 1
        if not s:
            continue
        if s.startswith("#"):
            if s[1:].split()[:1] == ["SPECIES"]:
                species = lines[i].split()
                i += 1
            continue
        if s[0] == "q":
            if not s[1:].strip().lower().startswith("n"):
                raise ValueError(f"{path}: only number abundances")
        elif s.startswith("ur"):
            rfct = float(s[2:])
        elif s.startswith("up"):
            pfct = float(s[2:])
        elif s[0] in "uzn":
            if s.startswith("ut") or s[0] == "z":
                raise ValueError(f"{path}: {s!r} is not supported")
        else:
            rows.append([float(v) for v in s.split()])
    arr = np.array(rows)
    if arr[0, 0] > arr[-1, 0]:
        arr = arr[::-1]
    mols = {}
    for s in Path(molfile).read_text().splitlines():
        f = s.split()
        if f and not f[0].startswith("#"):
            mols[f[1]] = (float(f[2]), float(f[3]) / 2.0 * ANGSTROM)
    return Atmosphere(species=species, radius=arr[:, 0].copy(), rfct=rfct,
                      press=arr[:, 1].copy(), pfct=pfct,
                      temp=arr[:, 2].copy(), q=arr[:, 3:].T.copy(),
                      mol_mass=np.array([mols[s][0] for s in species]),
                      mol_radius=np.array([mols[s][1] for s in species]))


@dataclasses.dataclass
class CiaTable:
    species: list
    temps: np.ndarray     # (nt,)
    wn: np.ndarray        # (nw,)
    cs: np.ndarray        # (nw, nt) cm-1 amagat^-2


def read_cia(path) -> CiaTable:
    species, temps, wn, rows = None, None, [], []
    for s in Path(path).read_text().splitlines():
        s = s.strip()
        if not s or s.startswith("#"):
            continue
        if s[0] == "i":
            species = s[1:].split()
        elif s[0] == "t" and temps is None:
            temps = np.array([float(t.rstrip("kK")) for t in s[1:].split()])
        else:
            v = [float(x) for x in s.split()]
            wn.append(v[0])
            rows.append(v[1:])
    return CiaTable(species, temps, np.array(wn), np.array(rows))


def ideal_gas_density(q, press_cgs, temps, mol_mass):
    """Mass densities (nmol, nl), g/cm3, of number abundances q."""
    return AMU * q * press_cgs / KB / temps * mol_mass[:, None]


@dataclasses.dataclass
class Problem:
    """The static inputs of a configuration, on the host."""
    cfg: dict
    atm: Atmosphere
    tli: LineList          # header and isotopes of the list
    lines: tuple           # (wl, isoid, elow, gf) of the list the run uses
    cia: list              # CiaTable per file


def load_problem(config: dict, root, tli_path=None) -> Problem:
    """The problem of ``config`` (a configuration file's contents) with
    its files under ``root``; ``tli_path``: the line list to read in
    place of the configuration's ``linedb`` (the split list a run
    writes)."""
    c = dict(config["transit"], mode=config["model"]["mode"])
    root = Path(root)
    atm = read_atmosphere(root / c["atm"], root / c["molfile"])
    tli = read_tli(tli_path or root / c["linedb"])
    return Problem(cfg=c, atm=atm, tli=tli,
                   lines=select_lines(tli, c["wnlow"], c["wnhigh"]),
                   cia=[read_cia(root / f) for f in c["csfile"].split(",")])
