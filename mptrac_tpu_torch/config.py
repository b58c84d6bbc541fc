"""Run configuration (control parameters).

Own copy of the JAX package's ``config.py`` (the MPTRAC control
system, reference
``scan_ctl`` mptrac.c:12110-12182 and
``mptrac_read_ctl`` c:6466-7436).  Control files use the same
``KEY = VALUE`` text format (``KEY[i]`` / ``KEY[*]`` array syntax,
case-insensitive keys) and the same CLI ``KEY VALUE`` override tail,
so reference test configurations run unmodified.

``Ctl`` is a plain dataclass of Python values: module enables and grid
sizes are read on the host, never from the device.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from mptrac_tpu_torch.utils.log import LOG, WARN

# Quantity registry: name -> (longname, unit)
# (reference SET_QNT calls, mptrac.c:6600-6711)
QUANTITIES: Dict[str, Tuple[str, str]] = {
    "idx": ("particle index", "-"),
    "ens": ("ensemble index", "-"),
    "stat": ("station flag", "-"),
    "m": ("mass", "kg"),
    "vmr": ("volume mixing ratio", "ppv"),
    "rp": ("particle radius", "microns"),
    "rhop": ("particle density", "kg/m^3"),
    "ps": ("surface pressure", "hPa"),
    "ts": ("surface temperature", "K"),
    "zs": ("surface height", "km"),
    "us": ("surface zonal wind", "m/s"),
    "vs": ("surface meridional wind", "m/s"),
    "ess": ("eastward turbulent surface stress", "N/m^2"),
    "nss": ("northward turbulent surface stress", "N/m^2"),
    "shf": ("surface sensible heat flux", "W/m^2"),
    "lsm": ("land-sea mask", "1"),
    "sst": ("sea surface temperature", "K"),
    "pbl": ("planetary boundary layer", "hPa"),
    "pt": ("tropopause pressure", "hPa"),
    "tt": ("tropopause temperature", "K"),
    "zt": ("tropopause geopotential height", "km"),
    "h2ot": ("tropopause water vapor", "ppv"),
    "zg": ("geopotential height", "km"),
    "p": ("pressure", "hPa"),
    "t": ("temperature", "K"),
    "rho": ("air density", "kg/m^3"),
    "u": ("zonal wind", "m/s"),
    "v": ("meridional wind", "m/s"),
    "w": ("vertical velocity", "hPa/s"),
    "h2o": ("water vapor", "ppv"),
    "o3": ("ozone", "ppv"),
    "lwc": ("cloud liquid water content", "kg/kg"),
    "rwc": ("cloud rain water content", "kg/kg"),
    "iwc": ("cloud ice water content", "kg/kg"),
    "swc": ("cloud snow water content", "kg/kg"),
    "cc": ("cloud cover", "1"),
    "pct": ("cloud top pressure", "hPa"),
    "pcb": ("cloud bottom pressure", "hPa"),
    "cl": ("total column cloud water", "kg/m^2"),
    "plcl": ("lifted condensation level", "hPa"),
    "plfc": ("level of free convection", "hPa"),
    "pel": ("equilibrium level", "hPa"),
    "cape": ("convective available potential energy", "J/kg"),
    "cin": ("convective inhibition", "J/kg"),
    "o3c": ("total column ozone", "DU"),
    "hno3": ("nitric acid", "ppv"),
    "oh": ("hydroxyl radical", "ppv"),
    "h2o2": ("hydrogen peroxide", "ppv"),
    "ho2": ("hydroperoxyl radical", "ppv"),
    "o1d": ("atomic oxygen", "ppv"),
    "mloss_oh": ("mass loss due to OH chemistry", "kg"),
    "mloss_h2o2": ("mass loss due to H2O2 chemistry", "kg"),
    "mloss_kpp": ("mass loss due to kpp chemistry", "kg"),
    "mloss_wet": ("mass loss due to wet deposition", "kg"),
    "mloss_dry": ("mass loss due to dry deposition", "kg"),
    "mloss_decay": ("mass loss due to decay", "kg"),
    "loss_rate": ("total loss rate", "s^-1"),
    "psat": ("saturation pressure over water", "hPa"),
    "psice": ("saturation pressure over ice", "hPa"),
    "pw": ("partial water vapor pressure", "hPa"),
    "sh": ("specific humidity", "kg/kg"),
    "rh": ("relative humidity", "%"),
    "rhice": ("relative humidity over ice", "%"),
    "theta": ("potential temperature", "K"),
    "zeta": ("zeta coordinate", "K"),
    "zeta_d": ("diagnosed zeta coordinate", "K"),
    "zeta_dot": ("velocity of zeta coordinate", "K/s"),
    "eta": ("eta coordinate", "1"),
    "eta_dot": ("velocity of eta coordinate", "1/s"),
    "tvirt": ("virtual temperature", "K"),
    "lapse": ("temperature lapse rate", "K/km"),
    "vh": ("horizontal velocity", "m/s"),
    "vz": ("vertical velocity", "m/s"),
    "pv": ("potential vorticity", "PVU"),
    "tdew": ("dew point temperature", "K"),
    "tice": ("frost point temperature", "K"),
    "tsts": ("STS existence temperature", "K"),
    "tnat": ("NAT existence temperature", "K"),
    "Cx": ("Trace species x volume mixing ratio", "ppv"),
    "Ch2o": ("H2O volume mixing ratio", "ppv"),
    "Co3": ("O3 volume mixing ratio", "ppv"),
    "Cco": ("CO volume mixing ratio", "ppv"),
    "Coh": ("HO volume mixing ratio", "ppv"),
    "Ch": ("H radical volume mixing ratio", "ppv"),
    "Cho2": ("HO2 volume mixing ratio", "ppv"),
    "Ch2o2": ("H2O2 volume mixing ratio", "ppv"),
    "Co1d": ("O(1D) volume mixing ratio", "ppv"),
    "Co3p": ("O(3P) radical volume mixing ratio", "ppv"),
    "Cccl4": ("CCl4 (CFC-10) volume mixing ratio", "ppv"),
    "Cccl3f": ("CCl3F (CFC-11) volume mixing ratio", "ppv"),
    "Cccl2f2": ("CCl2F2 (CFC-12) volume mixing ratio", "ppv"),
    "Cn2o": ("N2O volume mixing ratio", "ppv"),
    "Csf6": ("SF6 volume mixing ratio", "ppv"),
    "aoa": ("age of air", "s"),
    "Arn222": ("Rn-222 activity", "Bq"),
    "Apb210": ("Pb-210 activity", "Bq"),
    "Abe7": ("Be-7 activity", "Bq"),
    "Acs137": ("Cs-137 activity", "Bq"),
    "Ai131": ("I-131 activity", "Bq"),
    "Axe133": ("Xe-133 activity", "Bq"),
    "current_subdomain": ("current subdomain", "-"),
    "target_subdomain": ("target subdomain", "-"),
}

# Species presets: name -> dict of ctl overrides
# (reference mptrac.c:7035-7140)
SPECIES_TABLE: Dict[str, Dict[str, object]] = {
    "cf2cl2": dict(molmass=120.907, h=(3e-5, 3500.0)),
    "cfcl3": dict(molmass=137.359, h=(1.1e-4, 3300.0)),
    "ch4": dict(molmass=16.043, oh_reaction=2, oh=(2.45e-12, 1775.0),
                h=(1.4e-5, 1600.0)),
    "co": dict(molmass=28.01, oh_reaction=3,
               oh=(6.9e-33, 2.1, 1.1e-12, -1.3), h=(9.7e-6, 1300.0)),
    "co2": dict(molmass=44.009, h=(3.3e-4, 2400.0)),
    "h2o": dict(molmass=18.01528),
    "n2o": dict(molmass=44.013, h=(2.4e-4, 2600.0)),
    "nh3": dict(molmass=17.031, oh_reaction=2, oh=(1.7e-12, 710.0),
                h=(5.9e-1, 4200.0)),
    "hno3": dict(molmass=63.012, h=(2.1e3, 8700.0)),
    "no": dict(molmass=30.006, oh_reaction=3,
               oh=(7.1e-31, 2.6, 3.6e-11, 0.1), h=(1.9e-5, 1600.0)),
    "no2": dict(molmass=46.005, oh_reaction=3,
                oh=(1.8e-30, 3.0, 2.8e-11, 0.0), h=(1.2e-4, 2400.0)),
    "o3": dict(molmass=47.997, oh_reaction=2, oh=(1.7e-12, 940.0),
               h=(1e-4, 2800.0)),
    "sf6": dict(molmass=146.048, h=(2.4e-6, 3100.0)),
    "so2": dict(molmass=64.066, oh_reaction=3,
                oh=(2.9e-31, 4.1, 1.7e-12, -0.2), h=(1.3e-2, 2900.0)),
}


class CtlFile:
    """Parsed control source: file lines + CLI override tail.

    Matches reference ``scan_ctl`` semantics: file lines are
    ``NAME = VALUE`` (exactly three whitespace tokens; the middle token
    is ignored), keys are case-insensitive, CLI ``KEY VALUE`` pairs take
    precedence over the file, and a missing key without default is an
    error.
    """

    def __init__(self, filename: Optional[str] = None,
                 args: Sequence[str] = ()):
        self._file: Dict[str, str] = {}
        self._args: Dict[str, str] = {}
        self.used: Dict[str, str] = {}
        if filename and not filename.endswith("-"):
            with open(filename) as f:
                for line in f:
                    toks = line.split()
                    if len(toks) >= 3:
                        self._file.setdefault(toks[0].lower(), toks[2])
        args = list(args)
        for i in range(len(args) - 1):
            self._args.setdefault(args[i].lower(), args[i + 1])

    def scan(self, name: str, arridx: int = -1, default: Optional[str] = None):
        """Look up a key; returns the raw string value."""
        if arridx >= 0:
            keys = [f"{name}[{arridx}]".lower(), f"{name}[*]".lower()]
        else:
            keys = [name.lower()]
        val = None
        for k in keys:
            if k in self._file:
                val = self._file[k]
                break
        for k in keys:
            if k in self._args:
                val = self._args[k]
                break
        if val is None:
            if default is None or default == "":
                raise ValueError(f"Missing control variable {name}!")
            val = default
        self.used[keys[0]] = val
        # ctl echo (reference scan_ctl prints every key at LOG level 1)
        LOG(1, "%s = %s", keys[0].upper(), val)
        return val

    def unknown_file_keys(self):
        """File keys that no scan ever consumed (typo detection).

        A key counts as consumed only in a spelling that ``scan`` looks
        up: ``name`` and ``name[idx]`` when exactly that was scanned,
        ``name[*]`` when any element of the array was.  An index that no
        scan reached (``QNT_NAME[7]`` with ``NQ = 3``) is reported; the
        JAX package's check lets it pass because other elements of the
        array were scanned."""
        scanned_arrays = {u.split("[", 1)[0] for u in self.used if "[" in u}
        out = []
        for k in self._file:
            if k in self.used:
                continue
            if k.endswith("[*]") and k[:-3] in scanned_arrays:
                continue
            out.append(k)
        return out

    def scan_float(self, name, arridx=-1, default=None) -> float:
        return float(self.scan(name, arridx, default))

    def scan_int(self, name, arridx=-1, default=None) -> int:
        return int(float(self.scan(name, arridx, default)))

    def scan_str(self, name, arridx=-1, default=None) -> str:
        return self.scan(name, arridx, default)


@dataclass(frozen=True)
class Ctl:
    """Run control parameters (reference ``ctl_t``, mptrac.h:2284-3331).

    Static configuration: not a pytree.  Stepper functions close over a
    Ctl so that module enables/orders compile to a fixed graph.
    """

    # Quantities
    nq: int = 0
    qnt_name: Tuple[str, ...] = ()
    qnt_longname: Tuple[str, ...] = ()
    qnt_format: Tuple[str, ...] = ()
    qnt_unit: Tuple[str, ...] = ()

    # Coordinates
    met_coord_type: int = 0          # 0 = lat/lon, 1 = Cartesian/UTM
    met_utm_ref_lat: float = 0.0
    met_utm_ref_lon: float = 0.0
    advect_vert_coord: int = 0       # 0 omega/p, 1 diabatic zeta, 2/3 mlev
    met_vert_coord: int = 0
    met_gp2z: int = 0

    # Time stepping
    direction: int = 1
    t_start: float = -1e100          # < -1e99: derive from atm times
    t_stop: float = 1e100
    dt_mod: float = 180.0

    # Met data
    metbase: str = "-"
    dt_met: float = 3600.0
    met_convention: int = 0
    met_type: int = 0
    met_clams: int = 0
    met_nc_scale: int = 1
    met_nc_level: int = 0
    met_zstd_level: int = -3
    met_pck_zstd: int = 0
    # lossy codec settings per 3-D met variable (reference METVAR
    # order Z T U V W PV H2O O3 LWC RWC IWC SWC CC, c:969-983)
    met_lossy_scale: tuple = (0,) * 13
    met_sz3_prec: tuple = (11, 7, 7, 7, 13, 7, 18, 10, 13, 13, 13,
                           13, 6)
    met_sz3_tol: tuple = (0.0,) * 13
    met_zfp_prec: tuple = (12, 11, 7, 7, 6, 7, 10, 9, 6, 6, 6, 6, 9)
    met_zfp_tol: tuple = (0.0,) * 13
    met_cms_eps: tuple = (0.01,) * 13
    met_cms_zstd: int = 1
    met_cms_maxlev: int = 6
    met_dx: int = 1
    met_dy: int = 1
    met_dp: int = 1
    met_sx: int = 1
    met_sy: int = 1
    met_sp: int = 1
    met_detrend: float = -999.0
    met_np: int = 0
    met_press_level_def: int = -1
    met_p: Tuple[float, ...] = ()
    met_nlev: int = 0
    met_lev_hyam: Tuple[float, ...] = ()
    met_lev_hybm: Tuple[float, ...] = ()
    met_geopot_sx: int = -1
    met_geopot_sy: int = -1
    met_relhum: int = 0
    met_cape: int = 1
    met_pbl: int = 3
    met_pbl_min: float = 0.1
    met_pbl_max: float = 5.0
    met_tropo: int = 3
    met_tropo_pv: float = 3.5
    met_tropo_theta: float = 380.0
    met_tropo_spline: int = 1
    met_dt_out: float = 0.1
    met_cache: int = 0
    met_mpi_share: int = 0

    # Sorting
    sort_dt: float = -999.0
    #: fast path of the JAX package (key kept so the same control
    #: files parse; 0 = exact reference-parity arithmetic)
    tpu_fast: int = 0

    # Isosurface
    isosurf: int = 0
    balloon: str = "-"

    # Random number generator
    rng_type: int = 1                # 0 GSL-like, 1 Squares, 2 threefry

    # Advection
    advect: int = 2                  # 1 Euler, 2 midpoint, 4 RK4

    # Diffusion
    diffusion: int = 0
    turb_pbl_scheme: int = 0
    turb_dx_pbl: float = 50.0
    turb_dx_trop: float = 50.0
    turb_dx_strat: float = 0.0
    turb_dz_pbl: float = 0.0
    turb_dz_trop: float = 0.0
    turb_dz_strat: float = 0.1
    turb_mesox: float = 0.16
    turb_mesoz: float = 0.16
    turb_pbl_trans: float = 0.0

    # Convection
    conv_mix_pbl: int = 0
    conv_pbl_trans: float = 0.0
    conv_cape: float = -999.0
    conv_cin: float = -999.0
    conv_dt: float = -999.0

    # Boundary conditions
    bound_mass: float = -999.0
    bound_mass_trend: float = 0.0
    bound_vmr: float = -999.0
    bound_vmr_trend: float = 0.0
    bound_lat0: float = -999.0
    bound_lat1: float = -999.0
    bound_p0: float = -999.0
    bound_p1: float = -999.0
    bound_dps: float = -999.0
    bound_dzs: float = -999.0
    bound_zetas: float = -999.0
    bound_pbl: int = 0

    # Species
    species: str = "-"
    molmass: float = -999.0
    oh_chem_reaction: int = 0
    oh_chem: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 0.0)
    oh_chem_beta: float = 0.0
    h2o2_chem_reaction: int = 0
    kpp_chem: int = 0
    dt_kpp: float = 1800.0
    tracer_chem: int = 0
    radio_decay: int = 0

    # Deposition
    wet_depo_ic_h: Tuple[float, float] = (0.0, 0.0)
    wet_depo_bc_h: Tuple[float, float] = (0.0, 0.0)
    wet_depo_so2_ph: float = 0.0
    wet_depo_ic_a: float = 0.0
    wet_depo_ic_b: float = 0.0
    wet_depo_bc_a: float = 0.0
    wet_depo_bc_b: float = 0.0
    wet_depo_pre: Tuple[float, float] = (0.5, 0.36)
    wet_depo_ic_ret_ratio: float = 1.0
    wet_depo_bc_ret_ratio: float = 1.0
    dry_depo_vdep: float = 0.0
    dry_depo_dp: float = 30.0

    # Climatology files
    clim_photo: str = ""
    clim_hno3_filename: str = ""
    clim_oh_filename: str = ""
    clim_h2o2_filename: str = ""
    clim_ho2_filename: str = ""
    clim_o1d_filename: str = ""
    clim_ccl4_timeseries: str = "-"
    clim_ccl3f_timeseries: str = "-"
    clim_ccl2f2_timeseries: str = "-"
    clim_n2o_timeseries: str = "-"
    clim_sf6_timeseries: str = "-"

    # Mixing
    mixing_dt: float = 3600.0
    mixing_trop: float = -999.0
    mixing_strat: float = -999.0
    mixing_z0: float = -5.0
    mixing_z1: float = 85.0
    mixing_nz: int = 90
    mixing_lon0: float = -180.0
    mixing_lon1: float = 180.0
    mixing_nx: int = 360
    mixing_lat0: float = -90.0
    mixing_lat1: float = 90.0
    mixing_ny: int = 180

    # Chemistry grid
    chemgrid_z0: float = -5.0
    chemgrid_z1: float = 85.0
    chemgrid_nz: int = 90
    chemgrid_lon0: float = -180.0
    chemgrid_lon1: float = 180.0
    chemgrid_nx: int = 360
    chemgrid_lat0: float = -90.0
    chemgrid_lat1: float = 90.0
    chemgrid_ny: int = 180

    # Exponential decay
    tdec_trop: float = 0.0
    tdec_strat: float = 0.0

    # PSC
    psc_h2o: float = 4e-6
    psc_hno3: float = 9e-9

    # Output: atm
    atm_basename: str = "-"
    atm_gpfile: str = "-"
    atm_dt_out: float = 86400.0
    atm_filter: int = 0
    atm_stride: int = 1
    atm_type: int = 0
    atm_type_out: int = -1

    # Output: csi
    obs_type: int = 0
    csi_basename: str = "-"
    csi_kernel: str = "-"
    csi_dt_out: float = 86400.0
    csi_obsfile: str = "-"
    csi_obsmin: float = 0.0
    csi_modmin: float = 0.0
    csi_z0: float = -5.0
    csi_z1: float = 85.0
    csi_nz: int = 1
    csi_lon0: float = -180.0
    csi_lon1: float = 180.0
    csi_nx: int = 360
    csi_lat0: float = -90.0
    csi_lat1: float = 90.0
    csi_ny: int = 180

    # Output: ensembles
    nens: int = 0
    ens_basename: str = "-"
    ens_dt_out: float = 86400.0

    # Output: grid
    grid_basename: str = "-"
    grid_kernel: str = "-"
    grid_gpfile: str = "-"
    grid_dt_out: float = 86400.0
    grid_sparse: int = 0
    grid_stddev: int = 0
    grid_z0: float = -5.0
    grid_z1: float = 85.0
    grid_nz: int = 1
    grid_lon0: float = -180.0
    grid_lon1: float = 180.0
    grid_nx: int = 360
    grid_lat0: float = -90.0
    grid_lat1: float = 90.0
    grid_ny: int = 180
    grid_type: int = 0

    # Output: profiles / samples / stations / vtk
    prof_basename: str = "-"
    prof_obsfile: str = "-"
    prof_z0: float = 0.0
    prof_z1: float = 60.0
    prof_nz: int = 60
    prof_lon0: float = -180.0
    prof_lon1: float = 180.0
    prof_nx: int = 360
    prof_lat0: float = -90.0
    prof_lat1: float = 90.0
    prof_ny: int = 180
    sample_basename: str = "-"
    sample_kernel: str = "-"
    sample_obsfile: str = "-"
    sample_dx: float = 50.0
    sample_dz: float = -999.0
    stat_basename: str = "-"
    stat_lon: float = -999.0
    stat_lat: float = -999.0
    stat_r: float = 50.0
    stat_t0: float = -1e100
    stat_t1: float = 1e100
    vtk_basename: str = "-"
    vtk_dt_out: float = 86400.0
    vtk_stride: int = 1
    vtk_scale: float = 1.0
    vtk_offset: float = 0.0
    vtk_sphere: int = 0

    # Domain decomposition
    dd: int = 0
    dd_subdomains_meridional: int = 1
    dd_subdomains_zonal: int = 1
    dd_halos_size: int = 1
    dd_sort_dt: float = 1800.0

    # Quantity indices (set from the quantity registry; -1 = absent)
    # Dynamically added below for every name in QUANTITIES.

    def qnt(self, name: str) -> int:
        """Index of quantity ``name`` in the q array, or -1."""
        return self._qnt_idx.get(name, -1)

    @property
    def _qnt_idx(self) -> Dict[str, int]:
        object.__setattr__  # noqa: B018 (documented frozen access below)
        d = self.__dict__.get("_qnt_cache")
        if d is None:
            d = {n: i for i, n in enumerate(self.qnt_name)}
            object.__setattr__(self, "_qnt_cache", d)
        return d

    def replace(self, **kw) -> "Ctl":
        return dataclasses.replace(self, **kw)


def read_ctl(filename: Optional[str], args: Sequence[str] = ()) -> Ctl:
    """Build a Ctl from a control file plus CLI overrides.

    Mirrors reference ``mptrac_read_ctl`` (mptrac.c:6466-7436) including
    defaults and the SPECIES preset table.
    """
    s = CtlFile(filename, args)

    nq = s.scan_int("NQ", -1, "0")
    qnt_name, qnt_longname, qnt_format, qnt_unit = [], [], [], []
    for iq in range(nq):
        name = s.scan_str("QNT_NAME", iq)
        if name not in QUANTITIES:
            # Reference raises on unknown quantities (SET_QNT fallthrough)
            raise ValueError(f"Unknown quantity name: {name}")
        longname_def, unit_def = QUANTITIES[name]
        qnt_name.append(name)
        qnt_longname.append(s.scan_str("QNT_LONGNAME", iq, longname_def))
        qnt_format.append(s.scan_str("QNT_FORMAT", iq, "%g"))
        if name.startswith("aoa"):
            qnt_format[-1] = "%.2f"
        qnt_unit.append(s.scan_str("QNT_UNIT", iq, unit_def) or unit_def)

    kw: Dict[str, object] = dict(
        nq=nq,
        qnt_name=tuple(qnt_name),
        qnt_longname=tuple(qnt_longname),
        qnt_format=tuple(qnt_format),
        qnt_unit=tuple(qnt_unit),
    )

    kw["met_coord_type"] = s.scan_int("MET_COORD_TYPE", -1, "0")
    if kw["met_coord_type"] == 1:
        kw["met_utm_ref_lat"] = s.scan_float("MET_UTM_REF_LAT")
        kw["met_utm_ref_lon"] = s.scan_float("MET_UTM_REF_LON")
    kw["advect_vert_coord"] = s.scan_int("ADVECT_VERT_COORD", -1, "0")
    kw["met_vert_coord"] = s.scan_int("MET_VERT_COORD", -1, "0")
    kw["met_gp2z"] = s.scan_int("MET_GP2Z", -1, "0")
    kw["direction"] = s.scan_int("DIRECTION", -1, "1")
    kw["t_start"] = s.scan_float("T_START", -1, "-1e100")
    kw["t_stop"] = s.scan_float("T_STOP", -1, "1e100")
    kw["dt_mod"] = s.scan_float("DT_MOD", -1, "180")
    kw["metbase"] = s.scan_str("METBASE", -1, "-")
    kw["dt_met"] = s.scan_float("DT_MET", -1, "3600")
    kw["met_convention"] = s.scan_int("MET_CONVENTION", -1, "0")
    kw["met_type"] = s.scan_int("MET_TYPE", -1, "0")
    kw["met_clams"] = s.scan_int("MET_CLAMS", -1, "0")
    kw["met_nc_scale"] = s.scan_int("MET_NC_SCALE", -1, "1")
    kw["met_nc_level"] = s.scan_int("MET_NC_LEVEL", -1, "0")
    kw["met_zstd_level"] = s.scan_int("MET_ZSTD_LEVEL", -1, "-3")
    kw["met_pck_zstd"] = s.scan_int("MET_PCK_ZSTD", -1, "0")
    # lossy codec per-variable settings (reference c:6803-6875);
    # defaults match the reference's per-variable SZ3 precision table
    _sz3_defprec = ("11", "7", "7", "7", "13", "7", "18", "10", "13",
                    "13", "13", "13", "6")
    _defscale = s.scan_str("MET_LOSSY_SCALE", -1, "0")
    kw["met_lossy_scale"] = tuple(
        s.scan_int("MET_LOSSY_SCALE", i, _defscale) for i in range(13))
    kw["met_sz3_prec"] = tuple(
        s.scan_int("MET_SZ3_PREC", i, _sz3_defprec[i])
        for i in range(13))
    kw["met_sz3_tol"] = tuple(
        s.scan_float("MET_SZ3_TOL", i, "0.0") for i in range(13))
    _zfp_defprec = ("12", "11", "7", "7", "6", "7", "10", "9", "6",
                    "6", "6", "6", "9")
    kw["met_zfp_prec"] = tuple(
        s.scan_int("MET_ZFP_PREC", i, _zfp_defprec[i])
        for i in range(13))
    kw["met_zfp_tol"] = tuple(
        s.scan_float("MET_ZFP_TOL", i, "0.0") for i in range(13))
    kw["met_cms_eps"] = tuple(
        s.scan_float("MET_CMS_EPS", i, "0.01") for i in range(13))
    kw["met_cms_zstd"] = s.scan_int("MET_CMS_ZSTD", -1, "1")
    kw["met_cms_maxlev"] = s.scan_int("MET_CMS_MAXLEV", -1, "6")
    kw["met_dx"] = s.scan_int("MET_DX", -1, "1")
    kw["met_dy"] = s.scan_int("MET_DY", -1, "1")
    kw["met_dp"] = s.scan_int("MET_DP", -1, "1")
    kw["met_sx"] = s.scan_int("MET_SX", -1, "1")
    kw["met_sy"] = s.scan_int("MET_SY", -1, "1")
    kw["met_sp"] = s.scan_int("MET_SP", -1, "1")
    kw["met_detrend"] = s.scan_float("MET_DETREND", -1, "-999")
    kw["met_np"] = s.scan_int("MET_NP", -1, "0")
    kw["met_press_level_def"] = s.scan_int("MET_PRESS_LEVEL_DEF", -1, "-1")
    if kw["met_np"] > 0 and kw["met_press_level_def"] < 0:
        kw["met_p"] = tuple(
            s.scan_float("MET_P", ip) for ip in range(kw["met_np"]))
    kw["met_nlev"] = s.scan_int("MET_NLEV", -1, "0")
    if kw["met_nlev"] > 0:
        kw["met_lev_hyam"] = tuple(
            s.scan_float("MET_LEV_HYAM", ip) for ip in range(kw["met_nlev"]))
        kw["met_lev_hybm"] = tuple(
            s.scan_float("MET_LEV_HYBM", ip) for ip in range(kw["met_nlev"]))
    kw["met_geopot_sx"] = s.scan_int("MET_GEOPOT_SX", -1, "-1")
    kw["met_geopot_sy"] = s.scan_int("MET_GEOPOT_SY", -1, "-1")
    kw["met_relhum"] = s.scan_int("MET_RELHUM", -1, "0")
    kw["met_cape"] = s.scan_int("MET_CAPE", -1, "1")
    kw["met_pbl"] = s.scan_int("MET_PBL", -1, "3")
    kw["met_pbl_min"] = s.scan_float("MET_PBL_MIN", -1, "0.1")
    kw["met_pbl_max"] = s.scan_float("MET_PBL_MAX", -1, "5.0")
    kw["met_tropo"] = s.scan_int("MET_TROPO", -1, "3")
    kw["met_tropo_pv"] = s.scan_float("MET_TROPO_PV", -1, "3.5")
    kw["met_tropo_theta"] = s.scan_float("MET_TROPO_THETA", -1, "380")
    kw["met_tropo_spline"] = s.scan_int("MET_TROPO_SPLINE", -1, "1")
    kw["met_dt_out"] = s.scan_float("MET_DT_OUT", -1, "0.1")
    kw["met_cache"] = s.scan_int("MET_CACHE", -1, "0")
    kw["met_mpi_share"] = s.scan_int("MET_MPI_SHARE", -1, "0")
    kw["sort_dt"] = s.scan_float("SORT_DT", -1, "-999")
    kw["tpu_fast"] = s.scan_int("TPU_FAST", -1, "0")
    kw["isosurf"] = s.scan_int("ISOSURF", -1, "0")
    kw["balloon"] = s.scan_str("BALLOON", -1, "-")
    kw["rng_type"] = s.scan_int("RNG_TYPE", -1, "1")
    kw["advect"] = s.scan_int("ADVECT", -1, "2")
    if kw["advect"] not in (1, 2, 4):
        raise ValueError("Set ADVECT to 1, 2, or 4!")
    kw["diffusion"] = s.scan_int("DIFFUSION", -1, "0")
    kw["turb_pbl_scheme"] = s.scan_int("TURB_PBL_SCHEME", -1, "0")
    kw["turb_dx_pbl"] = s.scan_float("TURB_DX_PBL", -1, "50")
    kw["turb_dx_trop"] = s.scan_float("TURB_DX_TROP", -1, "50")
    kw["turb_dx_strat"] = s.scan_float("TURB_DX_STRAT", -1, "0")
    kw["turb_dz_pbl"] = s.scan_float("TURB_DZ_PBL", -1, "0")
    kw["turb_dz_trop"] = s.scan_float("TURB_DZ_TROP", -1, "0")
    kw["turb_dz_strat"] = s.scan_float("TURB_DZ_STRAT", -1, "0.1")
    kw["turb_mesox"] = s.scan_float("TURB_MESOX", -1, "0.16")
    kw["turb_mesoz"] = s.scan_float("TURB_MESOZ", -1, "0.16")
    kw["turb_pbl_trans"] = s.scan_float("TURB_PBL_TRANS", -1, "0")
    kw["conv_mix_pbl"] = s.scan_int("CONV_MIX_PBL", -1, "0")
    kw["conv_pbl_trans"] = s.scan_float("CONV_PBL_TRANS", -1, "0")
    kw["conv_cape"] = s.scan_float("CONV_CAPE", -1, "-999")
    kw["conv_cin"] = s.scan_float("CONV_CIN", -1, "-999")
    kw["conv_dt"] = s.scan_float("CONV_DT", -1, "-999")
    kw["bound_mass"] = s.scan_float("BOUND_MASS", -1, "-999")
    kw["bound_mass_trend"] = s.scan_float("BOUND_MASS_TREND", -1, "0")
    kw["bound_vmr"] = s.scan_float("BOUND_VMR", -1, "-999")
    kw["bound_vmr_trend"] = s.scan_float("BOUND_VMR_TREND", -1, "0")
    kw["bound_lat0"] = s.scan_float("BOUND_LAT0", -1, "-999")
    kw["bound_lat1"] = s.scan_float("BOUND_LAT1", -1, "-999")
    kw["bound_p0"] = s.scan_float("BOUND_P0", -1, "-999")
    kw["bound_p1"] = s.scan_float("BOUND_P1", -1, "-999")
    kw["bound_dps"] = s.scan_float("BOUND_DPS", -1, "-999")
    kw["bound_dzs"] = s.scan_float("BOUND_DZS", -1, "-999")
    kw["bound_zetas"] = s.scan_float("BOUND_ZETAS", -1, "-999")
    kw["bound_pbl"] = s.scan_int("BOUND_PBL", -1, "0")

    # Species presets
    species = s.scan_str("SPECIES", -1, "-")
    kw["species"] = species
    preset = SPECIES_TABLE.get(species.lower(), {})
    molmass_def = str(preset.get("molmass", -999.0))
    oh_def = preset.get("oh", (0.0, 0.0, 0.0, 0.0))
    oh_def = tuple(oh_def) + (0.0,) * (4 - len(oh_def))
    oh_reaction_def = preset.get("oh_reaction", 0)
    h_def = preset.get("h", (0.0, 0.0))

    kw["molmass"] = s.scan_float("MOLMASS", -1, molmass_def)
    kw["oh_chem_reaction"] = s.scan_int(
        "OH_CHEM_REACTION", -1, str(oh_reaction_def))
    kw["oh_chem"] = tuple(
        s.scan_float("OH_CHEM", ip, str(oh_def[ip])) for ip in range(4))
    kw["oh_chem_beta"] = s.scan_float("OH_CHEM_BETA", -1, "0")
    kw["h2o2_chem_reaction"] = s.scan_int("H2O2_CHEM_REACTION", -1, "0")
    kw["kpp_chem"] = s.scan_int("KPP_CHEM", -1, "0")
    kw["dt_kpp"] = s.scan_float("DT_KPP", -1, "1800")
    kw["tracer_chem"] = s.scan_int("TRACER_CHEM", -1, "0")
    kw["radio_decay"] = s.scan_int("RADIO_DECAY", -1, "0")
    kw["wet_depo_ic_h"] = (
        s.scan_float("WET_DEPO_IC_H", 0, str(h_def[0])),
        s.scan_float("WET_DEPO_IC_H", 1, str(h_def[1])))
    kw["wet_depo_bc_h"] = (
        s.scan_float("WET_DEPO_BC_H", 0, str(h_def[0])),
        s.scan_float("WET_DEPO_BC_H", 1, str(h_def[1])))
    kw["wet_depo_so2_ph"] = s.scan_float("WET_DEPO_SO2_PH", -1, "0")
    kw["wet_depo_ic_a"] = s.scan_float("WET_DEPO_IC_A", -1, "0")
    kw["wet_depo_ic_b"] = s.scan_float("WET_DEPO_IC_B", -1, "0")
    kw["wet_depo_bc_a"] = s.scan_float("WET_DEPO_BC_A", -1, "0")
    kw["wet_depo_bc_b"] = s.scan_float("WET_DEPO_BC_B", -1, "0")
    kw["wet_depo_pre"] = (
        s.scan_float("WET_DEPO_PRE", 0, "0.5"),
        s.scan_float("WET_DEPO_PRE", 1, "0.36"))
    kw["wet_depo_ic_ret_ratio"] = s.scan_float(
        "WET_DEPO_IC_RET_RATIO", -1, "1")
    kw["wet_depo_bc_ret_ratio"] = s.scan_float(
        "WET_DEPO_BC_RET_RATIO", -1, "1")
    kw["dry_depo_vdep"] = s.scan_float("DRY_DEPO_VDEP", -1, "0")
    kw["dry_depo_dp"] = s.scan_float("DRY_DEPO_DP", -1, "30")

    data_dir = os.environ.get(
        "MPTRAC_DATA", os.path.join(os.path.dirname(__file__), "data"))
    kw["clim_photo"] = s.scan_str(
        "CLIM_PHOTO", -1, os.path.join(data_dir, "clams_photolysis_rates.nc"))
    kw["clim_hno3_filename"] = s.scan_str(
        "CLIM_HNO3_FILENAME", -1, os.path.join(data_dir, "gozcards_HNO3.nc"))
    kw["clim_oh_filename"] = s.scan_str(
        "CLIM_OH_FILENAME", -1,
        os.path.join(data_dir, "clams_radical_species_vmr.nc"))
    kw["clim_h2o2_filename"] = s.scan_str(
        "CLIM_H2O2_FILENAME", -1, os.path.join(data_dir, "cams_H2O2.nc"))
    kw["clim_ho2_filename"] = s.scan_str(
        "CLIM_HO2_FILENAME", -1,
        os.path.join(data_dir, "clams_radical_species_vmr.nc"))
    kw["clim_o1d_filename"] = s.scan_str(
        "CLIM_O1D_FILENAME", -1,
        os.path.join(data_dir, "clams_radical_species_vmr.nc"))
    for key, attr in [("CLIM_CCL4_TIMESERIES", "clim_ccl4_timeseries"),
                      ("CLIM_CCL3F_TIMESERIES", "clim_ccl3f_timeseries"),
                      ("CLIM_CCL2F2_TIMESERIES", "clim_ccl2f2_timeseries"),
                      ("CLIM_N2O_TIMESERIES", "clim_n2o_timeseries"),
                      ("CLIM_SF6_TIMESERIES", "clim_sf6_timeseries")]:
        kw[attr] = s.scan_str(key, -1, "-")

    kw["mixing_dt"] = s.scan_float("MIXING_DT", -1, "3600.")
    kw["mixing_trop"] = s.scan_float("MIXING_TROP", -1, "-999")
    kw["mixing_strat"] = s.scan_float("MIXING_STRAT", -1, "-999")
    kw["mixing_z0"] = s.scan_float("MIXING_Z0", -1, "-5")
    kw["mixing_z1"] = s.scan_float("MIXING_Z1", -1, "85")
    kw["mixing_nz"] = s.scan_int("MIXING_NZ", -1, "90")
    kw["mixing_lon0"] = s.scan_float("MIXING_LON0", -1, "-180")
    kw["mixing_lon1"] = s.scan_float("MIXING_LON1", -1, "180")
    kw["mixing_nx"] = s.scan_int("MIXING_NX", -1, "360")
    kw["mixing_lat0"] = s.scan_float("MIXING_LAT0", -1, "-90")
    kw["mixing_lat1"] = s.scan_float("MIXING_LAT1", -1, "90")
    kw["mixing_ny"] = s.scan_int("MIXING_NY", -1, "180")
    kw["chemgrid_z0"] = s.scan_float("CHEMGRID_Z0", -1, "-5")
    kw["chemgrid_z1"] = s.scan_float("CHEMGRID_Z1", -1, "85")
    kw["chemgrid_nz"] = s.scan_int("CHEMGRID_NZ", -1, "90")
    kw["chemgrid_lon0"] = s.scan_float("CHEMGRID_LON0", -1, "-180")
    kw["chemgrid_lon1"] = s.scan_float("CHEMGRID_LON1", -1, "180")
    kw["chemgrid_nx"] = s.scan_int("CHEMGRID_NX", -1, "360")
    kw["chemgrid_lat0"] = s.scan_float("CHEMGRID_LAT0", -1, "-90")
    kw["chemgrid_lat1"] = s.scan_float("CHEMGRID_LAT1", -1, "90")
    kw["chemgrid_ny"] = s.scan_int("CHEMGRID_NY", -1, "180")
    kw["tdec_trop"] = s.scan_float("TDEC_TROP", -1, "0")
    kw["tdec_strat"] = s.scan_float("TDEC_STRAT", -1, "0")
    kw["psc_h2o"] = s.scan_float("PSC_H2O", -1, "4e-6")
    kw["psc_hno3"] = s.scan_float("PSC_HNO3", -1, "9e-9")

    kw["atm_basename"] = s.scan_str("ATM_BASENAME", -1, "-")
    kw["atm_gpfile"] = s.scan_str("ATM_GPFILE", -1, "-")
    kw["atm_dt_out"] = s.scan_float("ATM_DT_OUT", -1, "86400")
    kw["atm_filter"] = s.scan_int("ATM_FILTER", -1, "0")
    kw["atm_stride"] = s.scan_int("ATM_STRIDE", -1, "1")
    kw["atm_type"] = s.scan_int("ATM_TYPE", -1, "0")
    kw["atm_type_out"] = s.scan_int("ATM_TYPE_OUT", -1, "-1")
    if kw["atm_type_out"] == -1:
        kw["atm_type_out"] = kw["atm_type"]
    kw["obs_type"] = s.scan_int("OBS_TYPE", -1, "0")
    kw["csi_basename"] = s.scan_str("CSI_BASENAME", -1, "-")
    kw["csi_kernel"] = s.scan_str("CSI_KERNEL", -1, "-")
    kw["csi_dt_out"] = s.scan_float("CSI_DT_OUT", -1, "86400")
    kw["csi_obsfile"] = s.scan_str("CSI_OBSFILE", -1, "-")
    kw["csi_obsmin"] = s.scan_float("CSI_OBSMIN", -1, "0")
    kw["csi_modmin"] = s.scan_float("CSI_MODMIN", -1, "0")
    kw["csi_z0"] = s.scan_float("CSI_Z0", -1, "-5")
    kw["csi_z1"] = s.scan_float("CSI_Z1", -1, "85")
    kw["csi_nz"] = s.scan_int("CSI_NZ", -1, "1")
    kw["csi_lon0"] = s.scan_float("CSI_LON0", -1, "-180")
    kw["csi_lon1"] = s.scan_float("CSI_LON1", -1, "180")
    kw["csi_nx"] = s.scan_int("CSI_NX", -1, "360")
    kw["csi_lat0"] = s.scan_float("CSI_LAT0", -1, "-90")
    kw["csi_lat1"] = s.scan_float("CSI_LAT1", -1, "90")
    kw["csi_ny"] = s.scan_int("CSI_NY", -1, "180")
    kw["nens"] = s.scan_int("NENS", -1, "0")
    kw["ens_basename"] = s.scan_str("ENS_BASENAME", -1, "-")
    kw["ens_dt_out"] = s.scan_float("ENS_DT_OUT", -1, "86400")
    kw["grid_basename"] = s.scan_str("GRID_BASENAME", -1, "-")
    kw["grid_kernel"] = s.scan_str("GRID_KERNEL", -1, "-")
    kw["grid_gpfile"] = s.scan_str("GRID_GPFILE", -1, "-")
    kw["grid_dt_out"] = s.scan_float("GRID_DT_OUT", -1, "86400")
    kw["grid_sparse"] = s.scan_int("GRID_SPARSE", -1, "0")
    kw["grid_stddev"] = s.scan_int("GRID_STDDEV", -1, "0")
    kw["grid_z0"] = s.scan_float("GRID_Z0", -1, "-5")
    kw["grid_z1"] = s.scan_float("GRID_Z1", -1, "85")
    kw["grid_nz"] = s.scan_int("GRID_NZ", -1, "1")
    kw["grid_lon0"] = s.scan_float("GRID_LON0", -1, "-180")
    kw["grid_lon1"] = s.scan_float("GRID_LON1", -1, "180")
    kw["grid_nx"] = s.scan_int("GRID_NX", -1, "360")
    kw["grid_lat0"] = s.scan_float("GRID_LAT0", -1, "-90")
    kw["grid_lat1"] = s.scan_float("GRID_LAT1", -1, "90")
    kw["grid_ny"] = s.scan_int("GRID_NY", -1, "180")
    kw["grid_type"] = s.scan_int("GRID_TYPE", -1, "0")
    kw["prof_basename"] = s.scan_str("PROF_BASENAME", -1, "-")
    kw["prof_obsfile"] = s.scan_str("PROF_OBSFILE", -1, "-")
    kw["prof_z0"] = s.scan_float("PROF_Z0", -1, "0")
    kw["prof_z1"] = s.scan_float("PROF_Z1", -1, "60")
    kw["prof_nz"] = s.scan_int("PROF_NZ", -1, "60")
    kw["prof_lon0"] = s.scan_float("PROF_LON0", -1, "-180")
    kw["prof_lon1"] = s.scan_float("PROF_LON1", -1, "180")
    kw["prof_nx"] = s.scan_int("PROF_NX", -1, "360")
    kw["prof_lat0"] = s.scan_float("PROF_LAT0", -1, "-90")
    kw["prof_lat1"] = s.scan_float("PROF_LAT1", -1, "90")
    kw["prof_ny"] = s.scan_int("PROF_NY", -1, "180")
    kw["sample_basename"] = s.scan_str("SAMPLE_BASENAME", -1, "-")
    kw["sample_kernel"] = s.scan_str("SAMPLE_KERNEL", -1, "-")
    kw["sample_obsfile"] = s.scan_str("SAMPLE_OBSFILE", -1, "-")
    kw["sample_dx"] = s.scan_float("SAMPLE_DX", -1, "50")
    kw["sample_dz"] = s.scan_float("SAMPLE_DZ", -1, "-999")
    kw["stat_basename"] = s.scan_str("STAT_BASENAME", -1, "-")
    kw["stat_lon"] = s.scan_float("STAT_LON", -1, "0")
    kw["stat_lat"] = s.scan_float("STAT_LAT", -1, "0")
    kw["stat_r"] = s.scan_float("STAT_R", -1, "50")
    kw["stat_t0"] = s.scan_float("STAT_T0", -1, "-1e100")
    kw["stat_t1"] = s.scan_float("STAT_T1", -1, "1e100")
    kw["vtk_basename"] = s.scan_str("VTK_BASENAME", -1, "-")
    kw["vtk_dt_out"] = s.scan_float("VTK_DT_OUT", -1, "86400")
    kw["vtk_stride"] = s.scan_int("VTK_STRIDE", -1, "1")
    kw["vtk_scale"] = s.scan_float("VTK_SCALE", -1, "1")
    kw["vtk_offset"] = s.scan_float("VTK_OFFSET", -1, "0")
    kw["vtk_sphere"] = s.scan_int("VTK_SPHERE", -1, "0")

    # Domain decomposition (reference mptrac.c DD keys; DD=1 only when
    # compiled with domain decomposition — here a runtime option)
    kw["dd"] = s.scan_int("DD", -1, "0")
    if kw["dd"]:
        kw["dd_subdomains_meridional"] = s.scan_int(
            "DD_SUBDOMAINS_MERIDIONAL", -1, "1")
        kw["dd_subdomains_zonal"] = s.scan_int("DD_SUBDOMAINS_ZONAL", -1, "1")
    kw["dd_halos_size"] = s.scan_int("DD_HALOS_SIZE", -1, "1")
    kw["dd_sort_dt"] = s.scan_float("DD_SORT_DT", -1, "1800")

    # Unknown-key detection (framework extension; the reference
    # silently ignores misspelled ctl-file keys).  Only file keys are
    # checked — CLI tails legitimately carry arguments of the calling tool
    # (ATM_BASENAME etc.) consumed outside read_ctl.
    for k in s.unknown_file_keys():
        WARN("Unknown control parameter in %s: %s", filename, k.upper())

    return Ctl(**kw)
