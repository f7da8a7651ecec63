"""TLI v6 binary line-list format: reader and writer.

The TLI file is the contract between the line-list compiler and the RT
engine.  Layout (little-endian), from the reference writer
(pylineread/src/pylineread.py:195-425) and reader
(transit/src/readlineinfo.c:87-244, 416-537):

    u8[4]   magic  {0xff, 0xff-'T', 0xff-'L', 0xff-'I'} (endian sentinel)
    u16 x3  TLI version (=6), lineread version, lineread revision
    f64 x2  initial, final wavelength (microns)
    u16     number of databases
    per DB: u16 len + name;  u16 len + molecule name;  u16 nT;  u16 nIso
            f64[nT] temperatures
            per iso: u16 len + name; f64 mass (amu); f64 isotopic ratio;
                     f64[nT] partition function
    u64     total number of transitions N
    i32     number of isotopes-with-lines nIso
    u64[nIso] transitions per isotope
    f64[N] wavelength (um) | i16[N] isoID | f64[N] Elow (cm-1) | f64[N] gf
          (SoA blocks; each isotope's lines sorted by wavelength)
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

TLI_VERSION = 6
LR_VERSION = 6
LR_REVISION = 5
_MAGIC_LITTLE = b"\xff\xb6\xb3\xab"   # {0xff-'I'... } little-endian int32
_MAGIC_BIG = b"\xab\xb3\xb6\xff"


@dataclasses.dataclass
class TliIsotope:
    name: str
    mass: float            # amu
    ratio: float           # isotopic abundance ratio
    partition: np.ndarray  # (nT,) partition function at database temps


@dataclasses.dataclass
class TliDatabase:
    name: str
    molecule: str
    temps: np.ndarray          # (nT,)
    isotopes: list             # list[TliIsotope]


@dataclasses.dataclass
class TliData:
    """Parsed TLI content.  Line arrays are global, isoid indexes the
    concatenated isotope list across databases."""
    version: int
    iwav: float                # initial wavelength (um)
    fwav: float                # final wavelength (um)
    databases: list            # list[TliDatabase]
    wl: np.ndarray             # (N,) wavelength, microns
    isoid: np.ndarray          # (N,) int16
    elow: np.ndarray           # (N,) cm-1
    gf: np.ndarray             # (N,)
    isotran: np.ndarray        # (nIso,) transitions per isotope

    @property
    def n_lines(self):
        return self.wl.shape[0]

    def iso_index(self):
        """Flattened isotope list with database back-pointers.

        Returns (names, masses, ratios, dbidx, molnames) over the cumulative
        isotope ordering used by isoID (readlineinfo.c:188-224).
        """
        names, masses, ratios, dbidx, mols = [], [], [], [], []
        for d, db in enumerate(self.databases):
            for iso in db.isotopes:
                names.append(iso.name)
                masses.append(iso.mass)
                ratios.append(iso.ratio)
                dbidx.append(d)
                mols.append(db.molecule)
        return (names, np.array(masses), np.array(ratios),
                np.array(dbidx, dtype=np.int32), mols)


def read_tli(path: str) -> TliData:
    with open(path, "rb") as f:
        raw = f.read()
    off = 0

    def take(fmt):
        nonlocal off
        vals = struct.unpack_from("<" + fmt, raw, off)
        off += struct.calcsize("<" + fmt)
        return vals

    magic = raw[:4]
    off = 4
    if magic not in (_MAGIC_LITTLE, _MAGIC_BIG):
        raise ValueError(f"{path}: bad TLI magic {magic!r}")
    if magic == _MAGIC_BIG:
        raise ValueError(f"{path}: big-endian TLI files are not supported")

    tli_ver, lr_ver, lr_rev = take("3H")
    if tli_ver != TLI_VERSION:
        raise ValueError(f"{path}: TLI version {tli_ver}, expected "
                         f"{TLI_VERSION} (readlineinfo.c:108-115)")
    iwav, fwav = take("2d")
    (ndb,) = take("H")

    databases = []
    for _ in range(ndb):
        (ln,) = take("H")
        name = raw[off:off + ln].decode("ascii"); off += ln
        (ln,) = take("H")
        mol = raw[off:off + ln].decode("ascii"); off += ln
        nT, niso = take("2H")
        temps = np.frombuffer(raw, dtype="<f8", count=nT, offset=off).copy()
        off += 8 * nT
        isotopes = []
        for _ in range(niso):
            (ln,) = take("H")
            iname = raw[off:off + ln].decode("ascii"); off += ln
            mass, ratio = take("2d")
            z = np.frombuffer(raw, dtype="<f8", count=nT, offset=off).copy()
            off += 8 * nT
            isotopes.append(TliIsotope(iname, mass, ratio, z))
        databases.append(TliDatabase(name, mol, temps, isotopes))

    (nlines,) = take("Q")
    (niso_lines,) = take("i")
    isotran = np.frombuffer(raw, dtype="<u8", count=niso_lines,
                            offset=off).copy()
    off += 8 * niso_lines

    wl = np.frombuffer(raw, dtype="<f8", count=nlines, offset=off).copy()
    off += 8 * nlines
    isoid = np.frombuffer(raw, dtype="<i2", count=nlines, offset=off).copy()
    off += 2 * nlines
    elow = np.frombuffer(raw, dtype="<f8", count=nlines, offset=off).copy()
    off += 8 * nlines
    gf = np.frombuffer(raw, dtype="<f8", count=nlines, offset=off).copy()
    off += 8 * nlines

    return TliData(version=tli_ver, iwav=iwav, fwav=fwav, databases=databases,
                   wl=wl, isoid=isoid, elow=elow, gf=gf, isotran=isotran)


def bisect_mm(blk, x, side: str = "left") -> int:
    """searchsorted for memmap blocks via O(log n) single-element reads.

    The TLI line section starts at an odd byte offset (the reference's
    header has no alignment padding, pylineread.py:195-425), so an f8
    memmap view of it is UNALIGNED — and np.searchsorted silently
    copies unaligned input to an aligned buffer, turning one probe into
    a full read of the block (measured on a 1e9-line / 26 GB TLI:
    27 s per call cold, 8.6 s warm, vs 0.1 ms for this loop)."""
    lo, hi = 0, int(blk.shape[0])
    if side == "left":
        while lo < hi:
            mid = (lo + hi) // 2
            if blk[mid] < x:
                lo = mid + 1
            else:
                hi = mid
    else:
        while lo < hi:
            mid = (lo + hi) // 2
            if blk[mid] <= x:
                lo = mid + 1
            else:
                hi = mid
    return lo


def read_tli_band(path: str, wl_min_um: float, wl_max_um: float) -> TliData:
    """Read only the lines with wavelength in [wl_min, wl_max] microns.

    The per-host loading path for band-sharded multi-host runs (and the
    analogue of the reference's in-file binary search, readdatarng
    readlineinfo.c:416-537): headers are parsed normally, then each
    isotope's sorted wavelength block is searchsorted via memmap so only
    the window's records are touched — 1e9-line TLIs load in O(band).
    """
    header = read_tli_header(path)
    (data_off, nlines, isotran) = header["_line_layout"]
    wl_mm = np.memmap(path, dtype="<f8", mode="r", offset=data_off,
                      shape=(nlines,))
    iso_off = data_off + 8 * nlines
    el_off = iso_off + 2 * nlines
    gf_off = el_off + 8 * nlines
    iso_mm = np.memmap(path, dtype="<i2", mode="r", offset=iso_off,
                       shape=(nlines,))
    el_mm = np.memmap(path, dtype="<f8", mode="r", offset=el_off,
                      shape=(nlines,))
    gf_mm = np.memmap(path, dtype="<f8", mode="r", offset=gf_off,
                      shape=(nlines,))

    parts = []
    start = 0
    for cnt in isotran:
        cnt = int(cnt)
        block = wl_mm[start:start + cnt]
        lo = start + bisect_mm(block, wl_min_um, side="left")
        hi = start + bisect_mm(block, wl_max_um, side="right")
        parts.append((lo, hi))
        start += cnt
    wl = np.concatenate([np.asarray(wl_mm[lo:hi]) for lo, hi in parts])
    isoid = np.concatenate([np.asarray(iso_mm[lo:hi]) for lo, hi in parts])
    elow = np.concatenate([np.asarray(el_mm[lo:hi]) for lo, hi in parts])
    gf = np.concatenate([np.asarray(gf_mm[lo:hi]) for lo, hi in parts])
    new_isotran = np.array([hi - lo for lo, hi in parts if hi > lo],
                           dtype=np.uint64)
    return TliData(version=header["version"], iwav=header["iwav"],
                   fwav=header["fwav"], databases=header["databases"],
                   wl=wl, isoid=isoid, elow=elow, gf=gf,
                   isotran=new_isotran)


def read_tli_header(path: str) -> dict:
    """Parse only the TLI header (databases, partition functions) plus the
    line-section layout, without reading line data."""
    with open(path, "rb") as f:
        raw = f.read(4)
        if raw not in (_MAGIC_LITTLE, _MAGIC_BIG):
            raise ValueError(f"{path}: bad TLI magic {raw!r}")
        hdr = f.read(struct.calcsize("<3H2dH"))
        tli_ver, lr_ver, lr_rev, iwav, fwav, ndb = struct.unpack("<3H2dH",
                                                                 hdr)
        if tli_ver != TLI_VERSION:
            raise ValueError(f"{path}: TLI version {tli_ver}")
        databases = []
        for _ in range(ndb):
            (ln,) = struct.unpack("<H", f.read(2))
            name = f.read(ln).decode("ascii")
            (ln,) = struct.unpack("<H", f.read(2))
            mol = f.read(ln).decode("ascii")
            nT, niso = struct.unpack("<2H", f.read(4))
            temps = np.frombuffer(f.read(8 * nT), "<f8").copy()
            isotopes = []
            for _ in range(niso):
                (ln,) = struct.unpack("<H", f.read(2))
                iname = f.read(ln).decode("ascii")
                mass, ratio = struct.unpack("<2d", f.read(16))
                z = np.frombuffer(f.read(8 * nT), "<f8").copy()
                isotopes.append(TliIsotope(iname, mass, ratio, z))
            databases.append(TliDatabase(name, mol, temps, isotopes))
        (nlines,) = struct.unpack("<Q", f.read(8))
        (niso_l,) = struct.unpack("<i", f.read(4))
        isotran = np.frombuffer(f.read(8 * niso_l), "<u8").copy()
        data_off = f.tell()
    return {"version": tli_ver, "iwav": iwav, "fwav": fwav,
            "databases": databases,
            "_line_layout": (data_off, int(nlines), isotran)}


def write_tli(path: str, data: TliData) -> None:
    """Write a TLI v6 file readable by both this package and the reference."""
    out = bytearray()
    out += _MAGIC_LITTLE
    out += struct.pack("<3h", TLI_VERSION, LR_VERSION, LR_REVISION)
    out += struct.pack("<2d", data.iwav, data.fwav)
    out += struct.pack("<h", len(data.databases))
    for db in data.databases:
        name = db.name.encode("ascii")
        mol = db.molecule.encode("ascii")
        out += struct.pack("<h", len(name)) + name
        out += struct.pack("<h", len(mol)) + mol
        out += struct.pack("<2h", len(db.temps), len(db.isotopes))
        out += np.asarray(db.temps, dtype="<f8").tobytes()
        for iso in db.isotopes:
            iname = iso.name.encode("ascii")
            out += struct.pack("<h", len(iname)) + iname
            out += struct.pack("<2d", iso.mass, iso.ratio)
            z = np.asarray(iso.partition, dtype="<f8")
            assert z.shape[0] == len(db.temps)
            out += z.tobytes()

    n = data.wl.shape[0]
    out += struct.pack("<Q", n)
    out += struct.pack("<i", len(data.isotran))
    out += np.asarray(data.isotran, dtype="<u8").tobytes()
    # The four SoA line blocks are streamed with tofile (an ExoMol-scale
    # list is GBs; don't double it through a bytearray):
    with open(path, "wb") as f:
        f.write(bytes(out))
        np.asarray(data.wl, dtype="<f8").tofile(f)
        np.asarray(data.isoid, dtype="<i2").tofile(f)
        np.asarray(data.elow, dtype="<f8").tofile(f)
        np.asarray(data.gf, dtype="<f8").tofile(f)


def sort_lines(wl, isoid, elow, gf):
    """Sort lines by (isotope, wavelength) and compute isotran, as the
    reference compiler does (pylineread.py:364-383)."""
    wl = np.asarray(wl); isoid = np.asarray(isoid, dtype=np.int16)
    elow = np.asarray(elow); gf = np.asarray(gf)
    order = np.lexsort((wl, isoid))
    wl, isoid, elow, gf = wl[order], isoid[order], elow[order], gf[order]
    ids, counts = np.unique(isoid, return_counts=True)
    # isotran covers isotopes that actually have lines, in ascending isoID:
    isotran = counts.astype(np.uint64)
    return wl, isoid, elow, gf, isotran


def select_lines(data: TliData, wn_low: float, wn_high: float):
    """Clip lines to the coarse wavenumber window [wn_low, wn_high] (cm-1),
    mirroring readdatarng's per-isotope in-file binary search
    (readlineinfo.c:435-436, 496-526): lines with TLI wavelength in
    [1/wn_high, 1/wn_low] microns are loaded; the extinction kernel applies
    the finer computemolext range check afterwards.  Preserves file order,
    so co-add adjacency is identical to the reference."""
    from transit_tpu_torch.constants import TLI_WAV_UNITS
    iniw = 1.0 / (wn_high) / TLI_WAV_UNITS   # microns
    finw = 1.0 / (wn_low) / TLI_WAV_UNITS
    keep = (data.wl >= iniw) & (data.wl <= finw)
    return (data.wl[keep], data.isoid[keep], data.elow[keep], data.gf[keep])
