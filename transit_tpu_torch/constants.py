"""Physical constants in cgs units.

Values match the reference implementation's constant catalog
(reference: transit/include/constants_tr.h:19-47) so that spectra agree
bit-for-bit with the C code at double precision.
"""

import math

AMAGAT = 2.68678e19          # Amagat (cm-3)
RHOSTP = 1.29e-3             # Density at standard temperature and pressure
PI = 3.141592653589793
DEGREES = PI / 180.0         # degrees -> radians
GGRAV = 6.673e-8             # Gravitational constant (erg cm / g^2)
HOUR = 3600.0                # 1 hour (s)
AU = 14959786896040.492      # Astronomical unit (cm)
ANGSTROM = 1e-8              # Angstrom (cm)
MICRON = 1e-4                # micron (cm)
SUNMASS = 1.9891e33          # Solar mass (g)
SUNRADIUS = 6.957e10         # IAU solar radius (cm)
AMU = 1.66053886e-24         # Atomic mass unit (g)
LO = 2.686763e19             # Loschmidt constant (cm-3)
EC = 4.8032068e-10           # Electron charge (statC)
LS = 2.99792458e10           # Speed of light (cm/s)
ME = 9.1093897e-28           # Electron mass (g)
KB = 1.380658e-16            # Boltzmann constant (erg/K)
H = 6.6260755e-27            # Planck constant (erg s)
HC = H * LS                  # h*c (erg cm)
SIGCTE = PI * EC * EC / LS / LS / ME / AMU   # Line-strength constant (cm/g)
EXPCTE = H * LS / KB         # hc/k (cm K)
NAVOGADRO = 6.02214076e23    # Avogadro's number (mol-1)

ONEOSQRT2PI = 0.3989422804           # 1/sqrt(2 pi)
SQRTLN2 = 0.83255461115769775635     # sqrt(ln 2)
TWOOSQRTPI = 1.12837916709551257389  # 2/sqrt(pi)     (pu/src/voigt.c:29)
SQRTLN2PI = 0.46971863934982566689   # sqrt(ln2/pi)   (pu/src/voigt.c:30)

E0H2 = 4.911e-23   # Lecavelier Des Etangs et al. (2008) H2 Rayleigh e_0
RAYEXP = 4         # Rayleigh scattering wavenumber exponent

# TLI file conventions (reference: transit/src/readlineinfo.c:6-7)
TLI_WAV_UNITS = 1e-4   # TLI wavelengths are in microns
TLI_E_UNITS = 1.0      # TLI lower-state energies are in cm-1
TLI_VERSION = 6        # Supported TLI format version

MAXNAMELEN = 20

assert abs(SQRTLN2 - math.sqrt(math.log(2.0))) < 1e-15
