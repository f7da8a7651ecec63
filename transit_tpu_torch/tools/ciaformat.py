"""Data-prep utilities: convert public CIA/cross-section data to the CS
file format, and read spectrum outputs.

Reference: scripts/Borysow_format.py, HITRAN_CIA_format.py,
HITRAN_CS_format.py, Yurchenko_CH4_format.py, readtransit.py.

The CS format (io/crosssec.py): 'i <mol1> [mol2]' header, 't T1..Tn'
header, rows of wavenumber + per-temperature values (cm-1 amagat^-n).
"""

from __future__ import annotations

import sys

import numpy as np

N0 = 2.6867774e19   # Loschmidt number (cm-3), HITRAN_CIA_format.py:36


def write_cs(path, species, temps, wn, data, comment=""):
    """data: (nwave, ntemp)."""
    with open(path, "w") as f:
        if comment:
            for line in comment.splitlines():
                f.write(f"# {line}\n")
        f.write("i " + " ".join(species) + "\n")
        f.write("t " + " ".join(f"{t:.1f}" for t in temps) + "\n\n")
        f.write("# Wavenumber in cm-1, coefficients in cm-1 amagat-N:\n")
        for i, w in enumerate(wn):
            f.write(f"{w:10.2f} " +
                    " ".join(f"{v:.4e}" for v in data[i]) + "\n")


def borysow_to_cs(filein, fileout, mol1, mol2):
    """Borysow web tables: header line 2 lists temperatures with trailing
    'K'; data rows are wavenumber then one column per temperature
    (Borysow_format.py)."""
    with open(filein) as f:
        lines = f.readlines()
    temps = np.array([float(t.rstrip("K")) for t in lines[1].split()[1:]])
    rows = []
    for line in lines[2:]:
        s = line.strip()
        if not s or s.startswith("#"):
            continue
        rows.append([float(v) for v in s.split()])
    arr = np.array(rows)
    write_cs(fileout, [mol1, mol2], temps, arr[:, 0], arr[:, 1:],
             comment=f"Converted from Borysow table {filein}")


def hitran_cia_to_cs(filein, fileout, tstep=None, wstep=None):
    """HITRAN CIA files (Richard et al. 2012): repeated blocks of a header
    line ('<pair> <wn_i> <wn_f> <nwave> <temp> ...') followed by nwave rows
    of (wn, alpha) (HITRAN_CIA_format.py)."""
    with open(filein) as f:
        lines = f.readlines()
    header = lines[0].split()
    species = header[0].split("-")
    nwave = int(header[3])
    size = nwave + 1
    ntemp = len(lines) // size
    T = np.zeros(ntemp)
    wn = np.zeros(nwave)
    data = np.zeros((nwave, ntemp))
    for i in range(ntemp):
        T[i] = float(lines[size * i].split()[1:][3])
        for j in range(nwave):
            p = lines[size * i + j + 1].split()
            if i == 0:
                wn[j] = float(p[0])
            data[j, i] = float(p[1])
    if tstep:
        keep = np.concatenate([[0], np.where(np.diff(T // tstep) > 0)[0] + 1])
        T, data = T[keep], data[:, keep]
    if wstep:
        keep = np.concatenate([[0],
                               np.where(np.diff(wn // wstep) > 0)[0] + 1])
        wn, data = wn[keep], data[keep]
    write_cs(fileout, species, T, wn, data,
             comment=f"Converted from HITRAN CIA {filein}")


def exomol_xsec_to_cs(fileins, fileout, molecule):
    """Per-temperature ExoMol .sigma cross-section files (rows: wn sigma);
    temperature parsed from the filename's third '_' field with trailing
    'K' (Yurchenko_CH4_format.py).  sigma (cm2/molecule) is converted to
    cm-1 amagat-1 via the Loschmidt number."""
    ntemp = len(fileins)
    T = np.zeros(ntemp)
    data = None
    wn = None
    for j, fi in enumerate(fileins):
        d = np.loadtxt(fi)
        if data is None:
            wn = d[:, 0]
            data = np.zeros((wn.shape[0], ntemp))
        T[j] = float(fi.split("_")[2].rstrip("K").rstrip(".sigma"))
        data[:, j] = d[:, 1] * N0
    order = np.argsort(T)
    write_cs(fileout, [molecule], T[order], wn, data[:, order],
             comment="Converted from ExoMol cross sections")


def hitran_xsc_to_cs(fileins, fileout):
    """HITRAN .xsc cross-section files (Hargreaves et al. 2015 style,
    scripts/HITRAN_CS_format.py:29-60): one temperature per file; a
    fixed-width header record (molecule [0:20], initial/final wavenumber
    [20:30]/[30:40], point count [40:47], temperature [47:54], pressure
    [54:60], resolution [70:75]) followed by the cross-section values
    wrapped 10 per line.  The wavenumber grid is linspace(wn_init,
    wn_fin, nwave); sigma (cm2/molecule) converts to cm-1 amagat-1 via
    the Loschmidt number."""
    ntemp = len(fileins)
    T = np.zeros(ntemp)
    data = mol = wn = None
    for i, fi in enumerate(fileins):
        with open(fi) as f:
            hdr = f.readline()
            m = hdr[0:20].strip()
            wn_init = float(hdr[20:30])
            wn_fin = float(hdr[30:40])
            nwave = int(hdr[40:47])
            T[i] = float(hdr[47:54])
            vals = np.array(f.read().split()[:nwave], dtype=np.float64)
        if data is None:
            mol = m
            wn = np.linspace(wn_init, wn_fin, nwave)
            data = np.zeros((nwave, ntemp))
        elif m != mol or vals.shape[0] != wn.shape[0]:
            raise ValueError(f"{fi}: species/range mismatch with "
                             f"{fileins[0]}")
        data[:, i] = vals * N0
    order = np.argsort(T)
    write_cs(fileout, [mol], T[order], wn, data[:, order],
             comment="Converted from HITRAN .xsc cross sections")


def merge_cs(file1, file2, fileout):
    """Merge two CS tables of the same pair over disjoint temperature
    ranges onto the union wavenumber grid (Borysow_merge_H2H2.py role)."""
    from transit_tpu_torch.io.crosssec import read_cross_section
    a = read_cross_section(file1)
    b = read_cross_section(file2)
    assert a.species == b.species
    wn = np.union1d(a.wn, b.wn)
    temps = np.concatenate([a.temps, b.temps])
    order = np.argsort(temps)
    data = np.zeros((wn.shape[0], temps.shape[0]))
    for k, tb in enumerate((a, b)):
        off = 0 if tb is a else a.temps.shape[0]
        for j in range(tb.temps.shape[0]):
            data[:, off + j] = np.interp(wn, tb.wn, tb.cs[:, j],
                                         left=0.0, right=0.0)
    write_cs(fileout, a.species, temps[order], wn, data[:, order],
             comment=f"Merged {file1} + {file2}")


def read_spectrum(tfile, wn=True):
    """Read a spectrum output file (readtransit.py:22-63): first row is a
    header; returns (wavenumber-or-wavelength, spectrum)."""
    d = np.loadtxt(tfile, skiprows=1)
    wave, spec = d[:, 0], d[:, -1]
    if wn:
        wave = 1e4 / wave
    return wave, spec


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print("usage: ciaformat {borysow|hitran-cia|hitran-xsc|exomol|"
              "merge} args...")
        return 1
    cmd, *rest = argv
    if cmd == "borysow":
        borysow_to_cs(*rest)
    elif cmd == "hitran-cia":
        args = rest[:2] + [float(x) for x in rest[2:]]
        hitran_cia_to_cs(*args)
    elif cmd == "hitran-xsc":
        hitran_xsc_to_cs(rest[:-1], rest[-1])
    elif cmd == "exomol":
        exomol_xsec_to_cs(rest[:-2], rest[-2], rest[-1])
    elif cmd == "merge":
        merge_cs(*rest)
    else:
        print(f"unknown command {cmd}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
