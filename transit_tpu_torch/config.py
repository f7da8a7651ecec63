"""Configuration, compatible with reference .cfg files.

The reference merges CLI flags and parameter files through procopt
(pu/src/procopt.c); option names and defaults here match the option table in
transit/src/argum.c:112-320 so reference config files drive this framework
unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class TransitConfig:
    # Input/output files (argum.c:133-155):
    atm: Optional[str] = None
    linedb: Optional[str] = None
    csfile: Optional[str] = None          # comma-separated list
    molfile: str = "../inputs/molecules.dat"
    outspec: str = "outspectrum"
    outtoomuch: Optional[str] = None
    outsample: Optional[str] = None
    outintens: Optional[str] = None
    savefiles: bool = False

    # Radius options (argum.c:159-171):
    raddelt: float = -1.0                 # -1: keep atmosphere sampling
    radlow: float = 0.0
    radhigh: float = 0.0
    radfct: float = 0.0

    # Atmosphere options (argum.c:174-188):
    allowq: float = 1e-5
    refpress: Optional[float] = None
    refradius: Optional[float] = None
    gsurf: Optional[float] = None
    qmol: Optional[str] = None
    qscale: Optional[str] = None

    # Wavelength (argum.c:191-200):
    wllow: float = 0.0
    wlhigh: float = 0.0
    wlfct: float = 1e-4

    # Wavenumber (argum.c:203-218):
    wnlow: float = 0.0
    wnhigh: float = 0.0
    wndelt: float = 0.0
    wnosamp: int = 2160
    wnfct: float = 0.0

    # Voigt profiles (argum.c:221-235):
    ndop: int = 60
    nlor: int = 60
    dmin: float = 1e-3
    dmax: float = 0.25
    lmin: float = 1e-4
    lmax: float = 10.0
    nwidth: float = 20.0

    # Extinction (argum.c:238-267):
    ethreshold: float = 1e-8
    cloud: Optional[str] = None           # "flag,ext,top,bot[,...]"
    cloudtop: Optional[float] = None
    scattering: Optional[str] = None
    detailext: Optional[str] = None       # "filename:wn1,wn2,..."
    detailcia: Optional[str] = None
    detailtau: Optional[str] = None

    # Opacity grid (argum.c:270-284):
    saveext: Optional[str] = None
    opacityfile: Optional[str] = None
    tlow: float = 500.0
    thigh: float = 3000.0
    tempdelt: float = 100.0
    justOpacity: bool = False
    shareOpacity: bool = False

    # Ray solution (argum.c:287-303):
    solution: str = "eclipse"
    toomuch: float = 20.0
    taulevel: int = 1
    modlevel: int = 1

    # Geometry (argum.c:306-318):
    starrad: float = 1.125                # solar radii
    transparent: bool = False
    raygrid: str = "0 20 40 60 80"
    # Orbital parameters "smaxis,time,incl,ecc,long_node,arg_per" and
    # their unit factors (argum.c:307-314; defaults AU, hours, deg, 1,
    # deg, deg — geometry.c:26-31).  Only starrad affects the spectrum;
    # these feed rt/orbit.py's planet-position solution:
    gorbpar: Optional[str] = None
    gorbparfct: Optional[str] = None

    verb: int = 2

    def raygrid_list(self):
        return [float(a) for a in self.raygrid.split()]

    def orbit_params(self):
        """(smaxis, time, incl, ecc, long_node, arg_per) with unit factors
        applied per gorbparfct (geometry.c:26-44)."""
        from transit_tpu_torch.constants import AU, DEGREES, HOUR
        vals = [1.0, 0.0, 0.0, 0.0, 0.0, 0.0]
        if self.gorbpar:
            parts = self.gorbpar.split(",")
            if len(parts) > 6:
                raise ValueError(
                    f"gorbpar: expected at most 6 comma-separated values "
                    f"(smaxis,time,incl,ecc,long_node,arg_per), got "
                    f"{len(parts)}: {self.gorbpar!r}")
            for i, v in enumerate(parts):
                vals[i] = float(v)
        fcts = [AU, HOUR, DEGREES, 1.0, DEGREES, DEGREES]
        if self.gorbparfct:
            parts = self.gorbparfct.split(",")
            if len(parts) > 6:
                raise ValueError(
                    f"gorbparfct: expected at most 6 comma-separated unit "
                    f"factors, got {len(parts)}: {self.gorbparfct!r}")
            for i, v in enumerate(parts):
                if float(v) > 0:
                    fcts[i] = float(v)
        return vals, fcts


class ConfigError(ValueError):
    """A configuration value failed validation (the analogue of the
    reference's acceptgenhints/makewnsample diagnostics, which print a
    specific message and exit rather than crashing downstream)."""


def validate(cfg: TransitConfig) -> TransitConfig:
    """Range/consistency validation with specific diagnostics, mirroring
    acceptgenhints (argum.c:773-911), makewnsample's range checks
    (makesample.c:308-400), and the --cloud syntax checks
    (argum.c:636-718).  Returns cfg unchanged on success; raises
    ConfigError naming the offending option otherwise."""
    def err(msg):
        raise ConfigError(msg)

    # Wavenumber/wavelength range (makesample.c:317-364): the low edge
    # needs wnlow or wlhigh; the high edge needs wnhigh or wllow.
    if cfg.wnlow > 0:
        if cfg.wnfct < 0:
            err(f"wnfct: user-specified wavenumber factor is negative "
                f"({cfg.wnfct:g}).")
    elif not cfg.wlhigh > 0:
        err("wnlow/wlhigh: initial wavenumber (nor final wavelength) "
            "were correctly provided (one must be positive).")
    elif cfg.wlfct <= 0:
        err(f"wlfct: user-specified wavelength factor is not positive "
            f"({cfg.wlfct:g}).")
    if cfg.wnhigh > 0:
        if cfg.wnfct < 0:
            err(f"wnfct: user-specified wavenumber factor is negative "
                f"({cfg.wnfct:g}).")
    elif not cfg.wllow > 0:
        err("wnhigh/wllow: final wavenumber (nor initial wavelength) "
            "were correctly provided (one must be positive).")
    elif cfg.wlfct <= 0:
        err(f"wlfct: user-specified wavelength factor is not positive "
            f"({cfg.wlfct:g}).")
    if cfg.wndelt <= 0:
        err(f"wndelt: incorrect wavenumber spacing ({cfg.wndelt:g}), it "
            f"must be positive (makesample.c:376-380).")
    if cfg.wnosamp < 1:
        err(f"wnosamp: oversampling factor must be >= 1, got "
            f"{cfg.wnosamp}.")
    wnfct = cfg.wnfct if cfg.wnfct > 0 else 1.0
    lo = cfg.wnlow * wnfct if cfg.wnlow > 0 else 1.0 / (cfg.wlhigh *
                                                        cfg.wlfct)
    hi = cfg.wnhigh * wnfct if cfg.wnhigh > 0 else 1.0 / (cfg.wllow *
                                                          cfg.wlfct)
    if hi <= lo:
        err(f"wavenumber range is empty: low {lo:g} cm-1 >= high "
            f"{hi:g} cm-1 (check wnlow/wnhigh/wllow/wlhigh and their "
            f"unit factors).")

    # Solution registry (acceptsoltype, argum.c:750-765):
    if cfg.solution not in ("transit", "eclipse"):
        err(f"solution: kind {cfg.solution!r} is invalid. Currently "
            f"accepted are: transit, eclipse.")
    if cfg.taulevel not in (1, 2):
        err(f"taulevel: must be 1 or 2, got {cfg.taulevel}.")
    if cfg.taulevel == 2:
        err("taulevel 2 (variable refraction, totaltau2) is a stub that "
            "aborts in the reference (slantpath.c:135); use taulevel 1.")
    if cfg.modlevel not in (1, -1):
        err(f"modlevel: must be 1 or -1, got {cfg.modlevel}.")

    # Line-profile arguments (argum.c:811-830):
    if cfg.nwidth < 1:
        err(f"nwidth: times of maximum width has to be greater than one: "
            f"{cfg.nwidth:g}.")
    if cfg.ethreshold <= 0:
        err(f"ethresh: extinction-coefficient threshold "
            f"({cfg.ethreshold:.3e}) has to be positive.")
    if cfg.ndop < 1 or cfg.nlor < 1:
        err(f"ndop/nlor: Voigt table sizes must be >= 1, got "
            f"{cfg.ndop}/{cfg.nlor}.")
    if not (0 < cfg.dmin < cfg.dmax):
        err(f"dmin/dmax: need 0 < dmin < dmax, got {cfg.dmin:g}/"
            f"{cfg.dmax:g}.")
    if not (0 < cfg.lmin < cfg.lmax):
        err(f"lmin/lmax: need 0 < lmin < lmax, got {cfg.lmin:g}/"
            f"{cfg.lmax:g}.")

    # Reference-level (hydrostatic) parameters (argum.c:855-876):
    if cfg.refradius is not None and cfg.refradius < 0:
        err(f"refradius: reference radius level ({cfg.refradius:g}) must "
            f"be positive.")
    if cfg.refpress is not None and cfg.refpress < 0:
        err(f"refpress: reference pressure level ({cfg.refpress:g}) must "
            f"be positive.")
    if cfg.gsurf is not None and cfg.gsurf < 0:
        err(f"gsurf: surface gravity ({cfg.gsurf:g} cm s^-2) must be "
            f"positive.")

    # Eclipse ray grid (argum.c:879-881; the reference FINDME's the angle
    # sanity checks — here they are real):
    if cfg.solution == "eclipse":
        try:
            angles = cfg.raygrid_list()
        except ValueError:
            err(f"raygrid: could not parse {cfg.raygrid!r} as a "
                f"space-separated list of angles.")
        if not angles:
            err("raygrid: needs at least one incident angle.")
        if any(b <= a for a, b in zip(angles, angles[1:])):
            err(f"raygrid: angles must be strictly increasing, got "
                f"{cfg.raygrid!r}.")
        if angles[0] < 0 or angles[-1] >= 90:
            err(f"raygrid: angles must lie in [0, 90) degrees, got "
                f"{cfg.raygrid!r}.")

    # qscale/qmol pairing (argum.c:883-891):
    nqs = len(cfg.qscale.split(",")) if cfg.qscale else 0
    nqm = len(cfg.qmol.split(",")) if cfg.qmol else 0
    if nqs != nqm:
        err(f"qscale ({nqs}) and qmol ({nqm}) should have the same "
            f"number of elements.")

    if cfg.toomuch <= 0:
        err(f"toomuch: maximum optical depth must be positive, got "
            f"{cfg.toomuch:g}.")
    if cfg.starrad <= 0:
        err(f"starrad: stellar radius must be positive, got "
            f"{cfg.starrad:g}.")
    if not (cfg.raddelt == -1.0 or cfg.raddelt > 0):
        err(f"raddelt: radius spacing must be positive (resample) or -1 "
            f"(keep the atmosphere grid), got {cfg.raddelt:g}.")

    # Opacity-grid temperature sampling (maketempsample, makesample.c:613):
    if cfg.opacityfile or cfg.justOpacity:
        if cfg.thigh <= cfg.tlow or cfg.tempdelt <= 0:
            err(f"tlow/thigh/tempdelt: opacity-grid temperature sampling "
                f"[{cfg.tlow:g}, {cfg.thigh:g}] step {cfg.tempdelt:g} is "
                f"not a valid ascending grid.")

    # Cloud syntax (argum.c:636-718): 'type,ext,top,bot[,extra...]'
    if cfg.cloud is not None:
        names = {"ext": 1, "opa": 2, "B17": 3, "F18": 4, "P19": 5}
        head, *rest = [x.strip() for x in cfg.cloud.split(",")]
        flag = names.get(head)
        if flag is None:
            try:
                flag = int(float(head))
            except ValueError:
                err(f"cloud: unknown cloud type {head!r}; accepted are "
                    f"ext, opa, B17, F18, P19 (or the numeric flag 1-5).")
        if flag not in (1, 2, 3, 4, 5):
            err(f"cloud: flag must be 1-5, got {flag}.")
        nextra = {1: 0, 2: 0, 3: 1, 4: 3, 5: 3}[flag]
        if len(rest) < 3 + nextra:
            err(f"cloud: syntax error in option '--cloud', parameters "
                f"need to be given as cloudtype,cloudext,cloudtop,cloudbot"
                f"{',gamma' if flag == 3 else ''}"
                f"{',gamma,Q,r' if flag == 4 else ''}"
                f"{',gamma,sigma,refwn' if flag == 5 else ''} "
                f"(got {len(rest)} values after the type).")
        try:
            vals = [float(x) for x in rest]
        except ValueError:
            err(f"cloud: non-numeric cloud parameter in {cfg.cloud!r}.")
        if vals[1] > vals[2]:
            err(f"cloud: the cloud top ({vals[1]:g}) needs to be less "
                f"than the cloud bottom ({vals[2]:g}).")

    # shareOpacity (argum.c:304-306) selected the reference's SysV
    # shared-memory opacity segment (opacity.c:89-201) so N retrieval
    # workers on one node could mount one grid.  Here the grid lives in
    # device HBM and multi-process runs memmap only their own wavenumber
    # band (parallel/multihost.py); the flag is accepted for cfg
    # compatibility but has no effect — tell the user instead of
    # silently ignoring it:
    if cfg.shareOpacity:
        from transit_tpu_torch.utils.log import warn
        warn("shareOpacity is ignored: the opacity grid is loaded into "
             "device memory (and band-windowed per process in multi-host "
             "runs), replacing the reference's SysV shared-memory "
             "segment.")
    return cfg


_BOOL_FLAGS = {"justOpacity", "shareOpacity", "transparent", "savefiles"}
_INT_FIELDS = {"wnosamp", "ndop", "nlor", "taulevel", "modlevel", "verb"}
_STR_FIELDS = {"atm", "linedb", "csfile", "molfile", "outspec", "outtoomuch",
               "outsample", "outintens", "qmol", "qscale", "solution",
               "raygrid", "opacityfile", "cloud", "scattering", "saveext",
               "detailext", "detailcia", "detailtau", "gorbpar",
               "gorbparfct"}
_ALIASES = {"ethresh": "ethreshold"}


def load_config(path: str, **overrides) -> TransitConfig:
    """Parse a reference-style config file: 'name value' lines, '#'/';'
    comments (procopt.c getopt_long_files)."""
    cfg = TransitConfig()
    with open(path) as f:
        for line in f:
            s = line.strip()
            if not s or s[0] in "#;":
                continue
            parts = s.split(None, 1)
            name = _ALIASES.get(parts[0], parts[0])
            if not hasattr(cfg, name):
                raise ValueError(f"{path}: unknown option {parts[0]!r}")
            if name in _BOOL_FLAGS:
                setattr(cfg, name, True)
                continue
            val = parts[1].split("#")[0].strip() if len(parts) > 1 else ""
            if name in _STR_FIELDS:
                setattr(cfg, name, val)
            elif name in _INT_FIELDS:
                setattr(cfg, name, int(val))
            else:
                setattr(cfg, name, float(val))
    for k, v in overrides.items():
        setattr(cfg, _ALIASES.get(k, k), v)
    return cfg
