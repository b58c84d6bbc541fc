"""Gridded and statistical output writers (reference write_grid
mptrac.c:13242, write_grid_asc c:13441, write_csi c:12864, write_ens
c:13142, write_prof c:14165, write_sample c:14395, write_station
c:14560, write_vtk c:14649).

Counterpart of the JAX package's ``io/writers.py``, with the same file
formats, cell rules and arithmetic, but with the parcel state left on
its device.  The JAX writers copy every column of the state to the host;
here the masks, cell indices and sums over parcels are computed where
the parcels are (``index_add_`` / ``bincount`` into the grid, float64
sums, int64 counts), and only the binned results go to the host, with
the rows that are printed (the station's hits, the VTK stride).  On the
card ``index_add_`` adds in no fixed order, so sums agree with the CPU
to rounding and counts exactly.

The index rules of the JAX writers are kept: the grid writer floors
(``floor((x - x0) / dx)``), the CSI and profile writers truncate toward
zero (``astype(int)``), so a parcel up to one cell width below their
first edge lands in cell 0.  A non-finite coordinate lands in no cell.

The sample writer finds the parcels near each observation through a
hash of the parcels' Cartesian position into cubes at least one search
diameter wide: only parcels in a cube that an observation's ball
reaches are tested, with the JAX writer's tests in its arithmetic.

Stateful writers (CSI, profile, sample and station keep one open file
across the run) are classes; an ``io.output.OutputManager`` owns them.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from mptrac_tpu_torch.config import Ctl
from mptrac_tpu_torch.constants import H0, MA, P0, RA, RE
from mptrac_tpu_torch.io.kernel import (kernel_at, kernel_weight_t,
                                        read_kernel)
from mptrac_tpu_torch.io.obs import read_obs
from mptrac_tpu_torch.types import Atm

_D2R = np.pi / 180.0
F64 = torch.float64


def _z(p):
    """Altitude [km] of pressure [hPa] (tensor or numpy)."""
    if isinstance(p, torch.Tensor):
        return H0 * torch.log(P0 / p)
    return H0 * np.log(P0 / p)


def _press(z):
    """Pressure [hPa] of altitude [km] (tensor or numpy)."""
    if isinstance(z, torch.Tensor):
        return P0 * torch.exp(-z / H0)
    return P0 * np.exp(-z / H0)


def _rho(p, t):
    """Air density from pressure [hPa] and temperature [K]."""
    return 100.0 * p / (RA * t)


def _geo2cart(lon, lat):
    """Cartesian position [km] of (lon, lat) [deg] on the host, [..., 3]
    float64."""
    latr = _D2R * np.asarray(lat)
    lonr = _D2R * np.asarray(lon)
    cl = np.cos(latr)
    return np.stack([RE * cl * np.cos(lonr), RE * cl * np.sin(lonr),
                     RE * np.sin(latr)], axis=-1)


def _geo2cart_t(lon: torch.Tensor, lat: torch.Tensor):
    """``_geo2cart`` of tensors on their device: three float64 tensors
    (the host function's arithmetic on float64 coordinates)."""
    latr = float(_D2R) * lat.to(F64)
    lonr = float(_D2R) * lon.to(F64)
    rcl = RE * torch.cos(latr)
    return rcl * torch.cos(lonr), rcl * torch.sin(lonr), RE * torch.sin(latr)


def _interp_met_t(metbuf, t, p, lon, lat, name="t"):
    """Met field ``name`` at points given on the host (numpy ``p``,
    ``lon``, ``lat``; ``t`` a time or an array of times), interpolated in
    float64 on the met pair's device with the exact interpolation
    (``ops.interp``); returns a numpy array."""
    from mptrac_tpu_torch.ops import interp
    met01 = metbuf.pair
    dev = met01.lon.device

    def put(a):
        return torch.as_tensor(np.array(a, np.float64), device=dev)

    lon_t, lat_t, p_t = put(lon), put(lat), put(p)
    loc = interp.locate_3d(met01, lon_t, lat_t, p_t)
    ts = put(np.broadcast_to(np.asarray(t, np.float64), np.shape(lon)))
    return interp.interp_time_3d(met01, name, ts, loc).cpu().numpy()


def _axis_cells(x: torch.Tensor, x0: float, dx: float, n: int, ok,
                rule):
    """Cell index along one axis, ``rule`` (``torch.floor`` or
    ``torch.trunc``) of ``(x - x0) / dx``; ``ok`` narrowed to the parcels
    inside ``[0, n)``.  Returns (index int64, ok)."""
    f = rule((x - x0) / dx)
    ok = ok & (f >= 0) & (f < n)
    return torch.clamp(torch.nan_to_num(f), 0, n - 1).to(torch.int64), ok


def _in_window(atm: Atm, t0: float, t1: float) -> torch.Tensor:
    """Live parcels with ``t0 <= time <= t1``."""
    return atm.mask & (atm.time >= t0) & (atm.time <= t1)


#: on the card, sums into fewer bins than this are spread over copies of
#: each bin (by parcel index) and the copies added after: ``index_add_``
#: of 100M parcels into the 32 bins of an ensemble would otherwise
#: serialize on 32 addresses
_SPREAD_BINS = 1 << 16


def _bin_sum(idx: torch.Tensor, w: torch.Tensor, nbins: int) -> torch.Tensor:
    """float64 sums of ``w`` into ``nbins`` bins by ``idx`` (int64, every
    entry in ``[0, nbins)``)."""
    spread = (_SPREAD_BINS // nbins if w.device.type == "cuda" else 1)
    if spread <= 1:
        out = torch.zeros(nbins, dtype=F64, device=w.device)
        return out.index_add_(0, idx, w.to(F64))
    lane = torch.arange(idx.shape[0], device=idx.device) % spread
    out = torch.zeros(nbins * spread, dtype=F64, device=w.device)
    out.index_add_(0, idx * spread + lane, w.to(F64))
    return out.view(nbins, spread).sum(dim=1)


class GridWriter:
    """Binned 3-D grid output (reference write_grid, c:13242)."""

    def __init__(self, ctl: Ctl):
        self.ctl = ctl
        self.kz = self.kw = None
        if ctl.grid_kernel != "-":
            self.kz, self.kw = read_kernel(ctl.grid_kernel)

    def _bin_device(self, atm: Atm, t: float):
        """Counts and float64 sums of every quantity (and of its square)
        per grid cell on the parcels' device; the host gets the
        ``[nx*ny*nz]`` results."""
        ctl = self.ctl
        nx, ny, nz = ctl.grid_nx, ctl.grid_ny, ctl.grid_nz
        ngrid = nx * ny * nz
        dz = (ctl.grid_z1 - ctl.grid_z0) / nz
        dlon = (ctl.grid_lon1 - ctl.grid_lon0) / nx
        dlat = (ctl.grid_lat1 - ctl.grid_lat0) / ny
        dev = atm.time.device
        ok = _in_window(atm, t - 0.5 * ctl.dt_mod, t + 0.5 * ctl.dt_mod)
        z = _z(atm.p)
        ix, ok = _axis_cells(atm.lon, ctl.grid_lon0, dlon, nx, ok,
                             torch.floor)
        iy, ok = _axis_cells(atm.lat, ctl.grid_lat0, dlat, ny, ok,
                             torch.floor)
        iz, ok = _axis_cells(z, ctl.grid_z0, dz, nz, ok, torch.floor)
        idx = torch.where(ok, (ix * ny + iy) * nz + iz, ngrid)
        del ix, iy, iz, ok
        kern = None if self.kz is None else kernel_at(self.kz, self.kw, z)
        del z
        cnt = torch.bincount(idx, minlength=ngrid + 1)[:ngrid].cpu().numpy()
        means, sigmas = {}, {}
        for name in ctl.qnt_name:
            qv = atm.q[name]
            kq = qv if kern is None else kern * qv
            s1 = torch.zeros(ngrid + 1, dtype=F64, device=dev)
            s1.index_add_(0, idx, kq.to(F64))
            s2 = torch.zeros(ngrid + 1, dtype=F64, device=dev)
            s2.index_add_(0, idx, (kq * kq).to(F64))
            s1, s2 = s1[:ngrid].cpu().numpy(), s2[:ngrid].cpu().numpy()
            with np.errstate(invalid="ignore", divide="ignore"):
                mean = np.where(cnt > 0, s1 / np.maximum(cnt, 1), np.nan)
                var = s2 / np.maximum(cnt, 1) - mean ** 2
                sig = np.where(cnt > 0, np.sqrt(np.maximum(var, 0)),
                               np.nan)
            means[name] = (s1, mean)
            sigmas[name] = sig
        return cnt.astype(np.int64), means, sigmas

    def write(self, filename: str, metbuf, atm: Atm, t: float):
        ctl = self.ctl
        nx, ny, nz = ctl.grid_nx, ctl.grid_ny, ctl.grid_nz
        dz = (ctl.grid_z1 - ctl.grid_z0) / nz
        dlon = (ctl.grid_lon1 - ctl.grid_lon0) / nx
        dlat = (ctl.grid_lat1 - ctl.grid_lat0) / ny
        zc = ctl.grid_z0 + dz * (np.arange(nz) + 0.5)
        pressc = _press(zc)
        lonc = ctl.grid_lon0 + dlon * (np.arange(nx) + 0.5)
        latc = ctl.grid_lat0 + dlat * (np.arange(ny) + 0.5)
        area = (dlat * dlon * (RE * np.pi / 180.0) ** 2
                * np.cos(_D2R * latc))
        ngrid = nx * ny * nz

        cnt, means, sigmas = self._bin_device(atm, t)

        area3 = np.repeat(np.tile(area, nx), nz)
        cd = np.full(ngrid, np.nan)
        vmr_impl = np.full(ngrid, np.nan)
        if "m" in ctl.qnt_name:
            msum = means["m"][0]
            cd = msum / (1e6 * area3)
            if ctl.molmass > 0 and metbuf is not None:
                iz3 = np.tile(np.arange(nz), nx * ny)
                ix3 = np.repeat(np.arange(nx), ny * nz)
                iy3 = np.tile(np.repeat(np.arange(ny), nz), nx)
                temp = _interp_met_t(metbuf, t, pressc[iz3], lonc[ix3],
                                     latc[iy3])
                vmr_impl = np.where(
                    msum > 0,
                    MA / ctl.molmass * cd / (_rho(pressc[iz3], temp)
                                             * dz * 1e3), 0.0)

        if ctl.grid_type == 1:
            self._write_nc(filename, t, zc, lonc, latc, area, dz, cd,
                           vmr_impl, cnt, means, sigmas)
            return

        if ctl.grid_gpfile != "-":
            from mptrac_tpu_torch.io.atm_io import _gnuplot_pipe, _PipeCtx
            sink = _PipeCtx(_gnuplot_pipe(ctl.grid_gpfile, filename, t))
        else:
            sink = open(filename, "w")
        qfmt = [ctl.qnt_format[iq] for iq in range(ctl.nq)]
        cols = [means[name][1].tolist() for name in ctl.qnt_name]
        if ctl.grid_stddev:
            cols += [sigmas[name].tolist() for name in ctl.qnt_name]
            qfmt += qfmt
        cd_l, vmr_l, cnt_l = cd.tolist(), vmr_impl.tolist(), cnt.tolist()
        zc_l, lonc_l, latc_l = zc.tolist(), lonc.tolist(), latc.tolist()
        area_l = area.tolist()
        with sink as out:
            out.write(
                "# $1 = time [s]\n# $2 = altitude [km]\n"
                "# $3 = longitude [deg]\n# $4 = latitude [deg]\n"
                "# $5 = surface area [km^2]\n# $6 = layer depth [km]\n"
                "# $7 = column density (implicit) [kg/m^2]\n"
                "# $8 = volume mixing ratio (implicit) [ppv]\n"
                "# $9 = number of particles [1]\n")
            for iq, name in enumerate(ctl.qnt_name):
                out.write(f"# ${10 + iq} = {name} (mean) "
                          f"[{ctl.qnt_unit[iq]}]\n")
            if ctl.grid_stddev:
                for iq, name in enumerate(ctl.qnt_name):
                    out.write(f"# ${10 + ctl.nq + iq} = {name} (stddev) "
                              f"[{ctl.qnt_unit[iq]}]\n")
            out.write("\n")
            for gx in range(nx):
                if gx > 0 and ny > 1 and not ctl.grid_sparse:
                    out.write("\n")
                for gy in range(ny):
                    if gy > 0 and nz > 1 and not ctl.grid_sparse:
                        out.write("\n")
                    for gz in range(nz):
                        gi = (gx * ny + gy) * nz + gz
                        if ctl.grid_sparse and not vmr_l[gi] > 0:
                            continue
                        out.write(
                            "%.2f %g %g %g %g %g %g %g %d" % (
                                t, zc_l[gz], lonc_l[gx], latc_l[gy],
                                area_l[gy], dz, cd_l[gi], vmr_l[gi],
                                cnt_l[gi]))
                        for fmt, col in zip(qfmt, cols):
                            out.write(" " + fmt % col[gi])
                        out.write("\n")

    def _write_nc(self, filename, t, zc, lonc, latc, area, dz, cd,
                  vmr_impl, cnt, means, sigmas):
        """netCDF grid variant (reference write_grid_nc,
        c:13540-13663): dims (time, z, lat, lon), data transposed from
        the internal (ix, iy, iz) order to (iz, iy, ix).  Written as
        netCDF3 classic via scipy."""
        from scipy.io import netcdf_file
        ctl = self.ctl
        nx, ny, nz = ctl.grid_nx, ctl.grid_ny, ctl.grid_nz

        def t3(a):
            # (ix, iy, iz) flat -> [1, iz, iy, ix]
            return np.ascontiguousarray(
                np.asarray(a).reshape(nx, ny, nz).transpose(2, 1, 0)
            )[None]

        nc = netcdf_file(filename, "w")
        nc.createDimension("time", 1)
        nc.createDimension("z", nz)
        nc.createDimension("lat", ny)
        nc.createDimension("lon", nx)
        nc.createDimension("dz", 1)

        def defvar(name, dtype, dims, longname, unit, data):
            v = nc.createVariable(name, dtype, dims)
            v.long_name = longname
            v.units = unit
            v[:] = data
            return v

        defvar("time", "d", ("time",), "time",
               "seconds since 2000-01-01 00:00:00 UTC", [t])
        defvar("z", "d", ("z",), "altitude", "km", zc)
        defvar("lat", "d", ("lat",), "latitude", "degrees_north", latc)
        defvar("lon", "d", ("lon",), "longitude", "degrees_east", lonc)
        defvar("dz", "d", ("dz",), "layer depth", "km", [dz])
        defvar("area", "d", ("lat",), "surface area", "km**2", area)
        dims4 = ("time", "z", "lat", "lon")
        defvar("cd", "f", dims4, "column density", "kg m**-2", t3(cd))
        defvar("vmr_impl", "f", dims4,
               "volume mixing ratio (implicit)", "ppv", t3(vmr_impl))
        defvar("np", "i", dims4, "number of particles", "1",
               t3(cnt).astype(np.int32))
        for iq, name in enumerate(ctl.qnt_name):
            defvar(f"{name}_mean", "d", dims4, f"{name} (mean)",
                   ctl.qnt_unit[iq], t3(means[name][1]))
            if ctl.grid_stddev:
                defvar(f"{name}_stddev", "d", dims4,
                       f"{name} (stddev)", ctl.qnt_unit[iq],
                       t3(sigmas[name]))
        nc.close()


class EnsWriter:
    """Per-ensemble mean/stddev output (reference write_ens, c:13142).

    As in the JAX package, parcels are binned by their own ensemble ID
    (the reference snapshot accumulates into the constant bin
    ``ctl->qnt_ens``, c:13191-13199, an apparent regression).  Sums are
    float64 on the parcels' device, so the sigma columns (a difference of
    two means) agree with the JAX writer's float32 or pairwise sums only
    to their cancellation."""

    def __init__(self, ctl: Ctl):
        if ctl.qnt("ens") < 0:
            raise ValueError("Missing ensemble IDs!")
        self.ctl = ctl

    def write(self, filename: str, atm: Atm, t: float):
        ctl = self.ctl
        n = atm.np
        time = atm.time[:n]
        ok = (time >= t - 0.5 * ctl.dt_mod) & (time <= t + 0.5 * ctl.dt_mod)
        # astype(int): truncation; a non-finite ID counts as negative
        ens_f = torch.trunc(atm.q["ens"][:n])
        finite = torch.isfinite(ens_f)
        nens = 1
        if n:
            top = torch.where(finite, ens_f, -1.0).max()
            nens = max(int(top) + 1, 1)
        if bool((ok & ~(finite & (ens_f >= 0))).any()):
            raise ValueError("Ensemble ID is out of range!")
        idx = torch.where(ok, torch.nan_to_num(ens_f).to(torch.int64), nens)
        del ens_f, finite

        def bsum(w):
            return _bin_sum(idx, w, nens + 1)[:nens].cpu().numpy()

        cnt = torch.bincount(idx, minlength=nens + 1)[:nens].cpu().numpy()
        zs = bsum(_z(atm.p[:n]).to(F64))
        xm = np.stack([bsum(c) for c in _geo2cart_t(atm.lon[:n],
                                                    atm.lat[:n])], axis=-1)
        qs1, qs2 = {}, {}
        for name in ctl.qnt_name:
            q64 = atm.q[name][:n].to(F64)
            qs1[name], qs2[name] = bsum(q64), bsum(q64 * q64)
        with open(filename, "w") as out:
            out.write("# $1 = time [s]\n# $2 = altitude [km]\n"
                      "# $3 = longitude [deg]\n# $4 = latitude [deg]\n")
            for iq, name in enumerate(ctl.qnt_name):
                out.write(f"# ${5 + iq} = {name} (mean) "
                          f"[{ctl.qnt_unit[iq]}]\n")
            for iq, name in enumerate(ctl.qnt_name):
                out.write(f"# ${5 + ctl.nq + iq} = {name} (sigma) "
                          f"[{ctl.qnt_unit[iq]}]\n")
            out.write(f"# ${5 + 2 * ctl.nq} = number of members\n\n")
            for e in range(nens):
                if cnt[e] == 0:
                    continue
                xmean = xm[e]
                latm = np.rad2deg(math.asin(
                    xmean[2] / np.linalg.norm(xmean)))
                lonm = np.rad2deg(math.atan2(xmean[1], xmean[0]))
                out.write("%.2f %g %g %g" % (t, zs[e] / cnt[e], lonm,
                                             latm))
                for iq, name in enumerate(ctl.qnt_name):
                    out.write(" " + ctl.qnt_format[iq]
                              % (qs1[name][e] / cnt[e]))
                for iq, name in enumerate(ctl.qnt_name):
                    var = (qs2[name][e] / cnt[e]
                           - (qs1[name][e] / cnt[e]) ** 2)
                    out.write(" " + ctl.qnt_format[iq]
                              % (math.sqrt(var) if var > 0 else 0.0))
                out.write(" %d\n" % cnt[e])


class StationWriter:
    """Time series of parcels near a station (reference write_station,
    c:14560).  Keeps one open file across the run and sets the parcels'
    station flag ``stat`` on the device state, in place, before the rows
    are printed (the reference's order, c:14629-14637): a flagged parcel
    is not printed again."""

    def __init__(self, ctl: Ctl, filename: str):
        self.ctl = ctl
        self.out = open(filename, "w")
        self.out.write("# $1 = time [s]\n# $2 = altitude [km]\n"
                       "# $3 = longitude [deg]\n# $4 = latitude [deg]\n")
        for iq, name in enumerate(ctl.qnt_name):
            self.out.write(f"# ${iq + 5} = {name} "
                           f"[{ctl.qnt_unit[iq]}]\n")
        self.out.write("\n")
        self.x0 = _geo2cart(ctl.stat_lon, ctl.stat_lat).tolist()
        self.rmax2 = ctl.stat_r ** 2

    def write(self, atm: Atm, t: float):
        ctl = self.ctl
        ok = (_in_window(atm, t - 0.5 * ctl.dt_mod, t + 0.5 * ctl.dt_mod)
              & (atm.time >= ctl.stat_t0) & (atm.time <= ctl.stat_t1))
        if "stat" in atm.q:
            ok &= torch.trunc(atm.q["stat"]) == 0
        x1 = _geo2cart_t(atm.lon, atm.lat)
        d2 = None
        for c, c0 in zip(x1, self.x0):
            d = c - c0
            d2 = d * d if d2 is None else d2 + d * d
        ok &= d2 <= self.rmax2
        del x1, d2
        hit = torch.nonzero(ok).flatten()
        if hit.numel() == 0:
            self.out.flush()
            return
        if "stat" in atm.q:
            atm.q["stat"].index_fill_(0, hit, 1.0)
        time = atm.time[hit].cpu().numpy()
        p = atm.p[hit].cpu().numpy()
        lon = atm.lon[hit].cpu().numpy()
        lat = atm.lat[hit].cpu().numpy()
        qs = [atm.q[name][hit].cpu().numpy() for name in ctl.qnt_name]
        z = _z(p)
        for ip in range(hit.numel()):
            self.out.write("%.2f %g %g %g" % (time[ip], z[ip], lon[ip],
                                              lat[ip]))
            for iq in range(ctl.nq):
                self.out.write(" " + ctl.qnt_format[iq] % qs[iq][ip])
            self.out.write("\n")
        self.out.flush()

    def close(self):
        self.out.close()


class VtkWriter:
    """ParaView VTK point-cloud output (reference write_vtk, c:14649).
    Only every ``VTK_STRIDE``-th parcel goes to the host."""

    def __init__(self, ctl: Ctl):
        self.ctl = ctl

    def write(self, filename: str, atm: Atm, t: float):
        ctl = self.ctl
        n, s = atm.np, ctl.vtk_stride
        time = atm.time[:n:s].cpu().numpy()
        sel = (time >= t - 0.5 * ctl.dt_mod) & (time <= t + 0.5 * ctl.dt_mod)
        p = atm.p[:n:s].cpu().numpy()[sel]
        lon = atm.lon[:n:s].cpu().numpy()[sel]
        lat = atm.lat[:n:s].cpu().numpy()[sel]
        npts = int(sel.sum())
        with open(filename, "w") as out:
            out.write("# vtk DataFile Version 3.0\n"
                      "vtk output\nASCII\nDATASET POLYDATA\n")
            out.write(f"POINTS {npts} float\n")
            if ctl.vtk_sphere:
                radius = (RE + _z(p) * ctl.vtk_scale
                          + ctl.vtk_offset) / RE
                cl = np.cos(_D2R * lat)
                out.write("".join(
                    "%g %g %g\n" % (r * c * math.cos(_D2R * lo),
                                    r * c * math.sin(_D2R * lo),
                                    r * math.sin(_D2R * la))
                    for r, c, lo, la in zip(radius, cl, lon, lat)))
            else:
                zz = _z(p) * ctl.vtk_scale + ctl.vtk_offset
                out.write("".join(map("%g %g %g\n".__mod__,
                                      zip(lon.tolist(), lat.tolist(),
                                          zz.tolist()))))
            out.write(f"POINT_DATA {npts}\n")
            for name in ctl.qnt_name:
                out.write(f"SCALARS {name} float 1\n"
                          "LOOKUP_TABLE default\n")
                v = atm.q[name][:n:s].cpu().numpy()[sel]
                out.write("".join(map("%g\n".__mod__, v.tolist())))


def _obs_cells(rlon, rlat, rz, lon0, dlon, nx, lat0, dlat, ny, z0=None,
               dz=None, nz=None):
    """Cell of each observation by truncation (``astype(int)``) and
    whether it lies inside the grid; without ``z0`` a column index."""
    oix = ((rlon - lon0) / dlon).astype(int)
    oiy = ((rlat - lat0) / dlat).astype(int)
    inside = (oix >= 0) & (oix < nx) & (oiy >= 0) & (oiy < ny)
    if z0 is None:
        return oix * ny + oiy, inside
    oiz = ((rz - z0) / dz).astype(int)
    inside &= (oiz >= 0) & (oiz < nz)
    return (oix * ny + oiy) * nz + oiz, inside


def _parcel_cells(atm: Atm, ok, lon0, dlon, nx, lat0, dlat, ny, z0, dz,
                  nz):
    """Cell ``(ix * ny + iy) * nz + iz`` of each parcel by truncation,
    and ``ok`` narrowed to the parcels inside the grid."""
    ix, ok = _axis_cells(atm.lon, lon0, dlon, nx, ok, torch.trunc)
    iy, ok = _axis_cells(atm.lat, lat0, dlat, ny, ok, torch.trunc)
    iz, ok = _axis_cells(_z(atm.p), z0, dz, nz, ok, torch.trunc)
    return (ix * ny + iy) * nz + iz, ok


class CsiWriter:
    """Verification against observations: contingency table and error
    statistics (reference write_csi, c:12864).  Every step bins the
    observations of its window (host) and the model mass (device) into
    the CSI grid and accumulates the counts; every ``CSI_DT_OUT`` a row
    per ensemble member is written and the counts start again."""

    def __init__(self, ctl: Ctl, filename: str):
        if ctl.qnt("m") < 0:
            raise ValueError("Need quantity mass!")
        self.ctl = ctl
        self.ensemble = ctl.nens > 0
        if self.ensemble and ctl.qnt("ens") < 0:
            raise ValueError("Missing ensemble IDs!")
        self.rt, self.rz, self.rlon, self.rlat, self.robs = read_obs(
            ctl.csi_obsfile, ctl)
        self.kz = self.kw = None
        if ctl.csi_kernel != "-":
            self.kz, self.kw = read_kernel(ctl.csi_kernel)
        self.out = open(filename, "w")
        self.out.write(
            "# $1 = time [s]\n# $2 = ensemble ID\n"
            "# $3 = number of hits (cx)\n# $4 = number of misses (cy)\n"
            "# $5 = number of false alarms (cz)\n"
            "# $6 = number of observations (cx + cy)\n"
            "# $7 = number of forecasts (cx + cz)\n# $8 = bias (%)\n"
            "# $9 = POD (%)\n# $10 = FAR (%)\n# $11 = CSI (%)\n"
            "# $12 = hits by random chance\n# $13 = ETS (%)\n"
            "# $14 = Pearson R\n# $15 = Spearman R\n"
            "# $16 = mean error [kg/m²]\n# $17 = RMSE [kg/m²]\n"
            "# $18 = MAE [kg/m²]\n# $19 = log-likelihood\n"
            "# $20 = number of points\n\n")
        nensb = ctl.nens if self.ensemble else 1
        self.ct = np.zeros(nensb, int)
        self.cx = np.zeros(nensb, int)
        self.cy = np.zeros(nensb, int)
        self.cz = np.zeros(nensb, int)
        self.x = [[] for _ in range(nensb)]
        self.y = [[] for _ in range(nensb)]
        self.obsstdn = [[] for _ in range(nensb)]

    def _model_mass(self, atm: Atm, t0, t1, cells, grid, nensb, dims):
        """Kernel-weighted mass per ensemble member in the grid cells
        ``cells`` (host int array), ``[nensb, len(cells)]`` float64."""
        ok = _in_window(atm, t0, t1)
        midx, ok = _parcel_cells(atm, ok, *dims)
        if self.ensemble:
            ens = torch.trunc(atm.q["ens"])
            if bool((ok & ~(ens >= 0)).any()):
                raise ValueError("Ensemble ID is out of range!")
            ok &= ens < nensb
            midx = midx + torch.nan_to_num(ens).clamp(
                0, nensb - 1).to(torch.int64) * grid
        size = grid * nensb
        midx = torch.where(ok, midx, size)
        del ok
        w = kernel_weight_t(self.kz, self.kw, atm.p) * atm.q["m"].to(F64)
        modsum = torch.zeros(size + 1, dtype=F64, device=w.device)
        modsum.index_add_(0, midx, w)
        sel = (torch.arange(nensb, device=w.device)[:, None] * grid
               + torch.as_tensor(cells, device=w.device)[None, :])
        return modsum[sel].cpu().numpy()

    def write(self, atm: Atm, t: float):
        ctl = self.ctl
        nx, ny, nz = ctl.csi_nx, ctl.csi_ny, ctl.csi_nz
        grid = nx * ny * nz
        dz = (ctl.csi_z1 - ctl.csi_z0) / nz
        dlon = (ctl.csi_lon1 - ctl.csi_lon0) / nx
        dlat = (ctl.csi_lat1 - ctl.csi_lat0) / ny
        latc = ctl.csi_lat0 + dlat * (np.arange(ny) + 0.5)
        area = (dlat * dlon * (RE * np.pi / 180.0) ** 2
                * np.cos(_D2R * latc))
        t0, t1 = t - 0.5 * ctl.dt_mod, t + 0.5 * ctl.dt_mod
        dims = (ctl.csi_lon0, dlon, nx, ctl.csi_lat0, dlat, ny,
                ctl.csi_z0, dz, nz)

        # Observations (host)
        sel = ((self.rt >= t0) & (self.rt < t1) & np.isfinite(self.robs))
        oidx, inside = _obs_cells(self.rlon, self.rlat, self.rz, *dims)
        sel &= inside
        obscount = np.bincount(oidx[sel], minlength=grid)
        obssum = np.bincount(oidx[sel], weights=self.robs[sel],
                             minlength=grid)
        obssum2 = np.bincount(oidx[sel], weights=self.robs[sel] ** 2,
                              minlength=grid)
        # Only cells with observations enter the statistics: the model
        # is binned on the device and read back at those cells only
        cells = np.nonzero(obscount > 0)[0]
        if cells.size:
            with np.errstate(invalid="ignore", divide="ignore"):
                ocnt = obscount[cells]
                obsmean = obssum[cells] / ocnt
                obsstd = np.sqrt(np.maximum(
                    obssum2[cells] / ocnt - obsmean ** 2, 0.0))
            nensb = self.ct.size
            modsum = self._model_mass(atm, t0, t1, cells, grid, nensb,
                                      dims)
            area3 = area[cells // nz % ny]
            for e in range(nensb):
                mm = modsum[e].copy()
                pos = mm > 0
                mm[pos] = mm[pos] / (1e6 * area3[pos])
                self.ct[e] += int(cells.size)
                obs_hi = obsmean >= ctl.csi_obsmin
                mod_hi = mm >= ctl.csi_modmin
                self.cx[e] += int((obs_hi & mod_hi).sum())
                self.cy[e] += int((obs_hi & ~mod_hi).sum())
                self.cz[e] += int((~obs_hi & mod_hi).sum())
                keep = obs_hi | mod_hi
                self.x[e] += list(mm[keep])
                self.y[e] += list(obsmean[keep])
                self.obsstdn[e] += list(np.where(mod_hi[keep],
                                                 obsstd[keep], 0.0))

        if math.fmod(t, ctl.csi_dt_out) == 0:
            for e in range(self.ct.size):
                self._flush(e, t)

    def _flush(self, e, t):
        from scipy import stats as sstats
        n = len(self.x[e])
        if n == 0:
            return
        cx, cy, cz, ct = (self.cx[e], self.cy[e], self.cz[e], self.ct[e])
        n_obs, n_for = cx + cy, cx + cz
        cx_rd = (n_obs * n_for) / ct if ct > 0 else math.nan
        bias = 100.0 * n_for / n_obs if n_obs > 0 else math.nan
        pod = 100.0 * cx / n_obs if n_obs > 0 else math.nan
        far = 100.0 * cz / n_for if n_for > 0 else math.nan
        csi = (100.0 * cx / (cx + cy + cz)
               if cx + cy + cz > 0 else math.nan)
        ets = (100.0 * (cx - cx_rd) / (cx + cy + cz - cx_rd)
               if cx + cy + cz - cx_rd > 0 else math.nan)
        xa = np.array(self.x[e])
        ya = np.array(self.y[e])
        with np.errstate(invalid="ignore"):
            rho_p = (np.corrcoef(xa, ya)[0, 1] if n > 1 else math.nan)
            rho_s = (sstats.spearmanr(xa, ya).statistic
                     if n > 1 else math.nan)
        work = xa - ya
        stdn = np.array(self.obsstdn[e])
        work2 = np.where(stdn != 0, work / np.where(stdn != 0, stdn, 1),
                         0.0)
        mean = float(np.mean(work))
        rmse = float(np.sqrt(np.mean(work ** 2)))
        absdev = float(np.mean(np.abs(work)))
        loglik = float(np.sum(work2 ** 2)) * -0.5
        self.out.write(
            "%.2f %d %d %d %d %d %d %g %g %g %g %g %g %g %g %g %g %g %g"
            " %d\n" % (
                t, e if self.ensemble else -999, cx, cy, cz, n_obs,
                n_for, bias, pod, far, csi, cx_rd, ets, rho_p, rho_s,
                mean, rmse, absdev, loglik, n))
        self.out.flush()
        self.ct[e] = self.cx[e] = self.cy[e] = self.cz[e] = 0
        self.x[e] = []
        self.y[e] = []
        self.obsstdn[e] = []

    def close(self):
        self.out.close()


class ProfWriter:
    """Vertical profiles at observation locations (reference
    write_prof, c:14165): for every grid column with observations in the
    step's window and model mass in it, one block of rows with the
    column's volume mixing ratio and the met's T, H2O and O3.  The mass
    is binned on the device; only the columns with observations go to
    the host, and the met is interpolated at all of them in one call."""

    def __init__(self, ctl: Ctl, filename: str):
        if ctl.qnt("m") < 0:
            raise ValueError("Need quantity mass!")
        if ctl.molmass <= 0:
            raise ValueError("Specify molar mass!")
        self.ctl = ctl
        self.rt, self.rz, self.rlon, self.rlat, self.robs = read_obs(
            ctl.prof_obsfile, ctl)
        self.out = open(filename, "w")
        self.out.write(
            "# $1 = time [s]\n# $2 = altitude [km]\n"
            "# $3 = longitude [deg]\n# $4 = latitude [deg]\n"
            "# $5 = pressure [hPa]\n# $6 = temperature [K]\n"
            "# $7 = volume mixing ratio [ppv]\n"
            "# $8 = H2O volume mixing ratio [ppv]\n"
            "# $9 = O3 volume mixing ratio [ppv]\n"
            "# $10 = observed BT index [K]\n"
            "# $11 = number of observations\n")

    def write(self, metbuf, atm: Atm, t: float):
        ctl = self.ctl
        nx, ny, nz = ctl.prof_nx, ctl.prof_ny, ctl.prof_nz
        dz = (ctl.prof_z1 - ctl.prof_z0) / nz
        dlon = (ctl.prof_lon1 - ctl.prof_lon0) / nx
        dlat = (ctl.prof_lat1 - ctl.prof_lat0) / ny
        zc = ctl.prof_z0 + dz * (np.arange(nz) + 0.5)
        pressc = _press(zc)
        lonc = ctl.prof_lon0 + dlon * (np.arange(nx) + 0.5)
        latc = ctl.prof_lat0 + dlat * (np.arange(ny) + 0.5)
        area = (dlat * dlon * (RE * np.pi / 180.0) ** 2
                * np.cos(_D2R * latc))
        t0, t1 = t - 0.5 * ctl.dt_mod, t + 0.5 * ctl.dt_mod

        sel = ((self.rt >= t0) & (self.rt < t1) & np.isfinite(self.robs))
        oidx, inside = _obs_cells(self.rlon, self.rlat, None,
                                  ctl.prof_lon0, dlon, nx, ctl.prof_lat0,
                                  dlat, ny)
        sel &= inside
        obscount = np.bincount(oidx[sel], minlength=nx * ny)
        obssum = np.bincount(oidx[sel], weights=self.robs[sel],
                             minlength=nx * ny)
        cols = np.nonzero(obscount > 0)[0]
        if cols.size == 0:
            self.out.flush()
            return

        ok = _in_window(atm, t0, t1)
        midx, ok = _parcel_cells(atm, ok, ctl.prof_lon0, dlon, nx,
                                 ctl.prof_lat0, dlat, ny, ctl.prof_z0, dz,
                                 nz)
        size = nx * ny * nz
        midx = torch.where(ok, midx, size)
        del ok
        dev = midx.device
        mass = torch.zeros(size + 1, dtype=F64, device=dev)
        mass.index_add_(0, midx, atm.q["m"].to(F64))
        del midx
        mass = mass[:size].view(nx * ny, nz)[
            torch.as_tensor(cols, device=dev)].cpu().numpy()
        has = (mass > 0).any(axis=1)
        cols, mass = cols[has], mass[has]
        if cols.size:
            gx, gy = cols // ny, cols % ny
            plon = np.repeat(lonc[gx], nz)
            plat = np.repeat(latc[gy], nz)
            pp = np.tile(pressc, cols.size)
            temp, h2o, o3 = (
                _interp_met_t(metbuf, t, pp, plon, plat, name).reshape(
                    cols.size, nz) for name in ("t", "h2o", "o3"))
            # the row's repeated fields are formatted once (the text is
            # the JAX writer's "%.2f %g ... %d" row, field by field)
            levels = ["%.2f %g" % (t, z) for z in zc]
            press = [" %g" % v for v in pressc]
            for k, i2 in enumerate(cols.tolist()):
                vmr = (MA / ctl.molmass * mass[k]
                       / (_rho(pressc, temp[k]) * area[gy[k]] * dz * 1e9))
                col = " %g %g" % (lonc[gx[k]], latc[gy[k]])
                tail = " %g %d\n" % (obssum[i2] / obscount[i2],
                                     obscount[i2])
                self.out.write("\n" + "".join(
                    lev + col + p + " %g %g %g %g" % v + tail
                    for lev, p, v in zip(levels, press, zip(
                        temp[k].tolist(), vmr.tolist(), h2o[k].tolist(),
                        o3[k].tolist()))))
        self.out.flush()

    def close(self):
        self.out.close()


class SampleWriter:
    """Model mass around observation points (reference write_sample,
    c:14395): for every observation of the step's window the parcels
    within ``SAMPLE_DX`` (chord distance) and, with ``SAMPLE_DZ > 0``,
    within the pressure layer ``rz +- SAMPLE_DZ``.

    The parcels near an observation are found through a hash of their
    Cartesian position (float32) into cubes of edge ``CUBE`` >= twice
    the search radius: each observation marks the cubes that its ball,
    widened by a margin far above float32 rounding, reaches, and only
    the parcels in a marked cube are tested against the observations
    that marked it, with the JAX writer's tests in float64."""

    #: cubes per axis at most (the table is ``GRID_MAX ** 3`` int32)
    GRID_MAX = 256
    #: widening of an observation's ball [km] against the float32 hash
    MARGIN = 0.1

    def __init__(self, ctl: Ctl, filename: str):
        self.ctl = ctl
        self.rt, self.rz, self.rlon, self.rlat, self.robs = read_obs(
            ctl.sample_obsfile, ctl)
        self.kz = self.kw = None
        if ctl.sample_kernel != "-":
            self.kz, self.kw = read_kernel(ctl.sample_kernel)
        self.out = open(filename, "w")
        self.out.write(
            "# $1 = time [s]\n# $2 = altitude [km]\n"
            "# $3 = longitude [deg]\n# $4 = latitude [deg]\n"
            "# $5 = surface area [km^2]\n# $6 = layer depth [km]\n"
            "# $7 = number of particles [1]\n"
            "# $8 = column density [kg/m^2]\n"
            "# $9 = volume mixing ratio [ppv]\n"
            "# $10 = observed BT index [K]\n\n")
        self.dlat = ctl.sample_dx * 180.0 / (np.pi * RE)
        self.rmax2 = ctl.sample_dx ** 2
        self.area = np.pi * self.rmax2
        reach = RE + self.MARGIN + abs(ctl.sample_dx)
        self.cube = max(2.0 * abs(ctl.sample_dx) + 2.0 * self.MARGIN,
                        2.0 * reach / (self.GRID_MAX - 3))
        self.ncube = int(math.ceil(2.0 * reach / self.cube)) + 2
        self.origin = -reach - self.cube

    def _marked_cubes(self, x0):
        """(cube ids, observation slot) pairs of every cube that the
        ball of each observation (``x0``: [nobs, 3] km) reaches."""
        r = abs(self.ctl.sample_dx) + self.MARGIN
        lo = np.floor((x0 - r - self.origin) / self.cube).astype(np.int64)
        hi = np.floor((x0 + r - self.origin) / self.cube).astype(np.int64)
        g = self.ncube
        ids, obs = [], []
        for k in range(x0.shape[0]):
            for cx in range(lo[k, 0], hi[k, 0] + 1):
                for cy in range(lo[k, 1], hi[k, 1] + 1):
                    for cz in range(lo[k, 2], hi[k, 2] + 1):
                        ids.append((cx * g + cy) * g + cz)
                        obs.append(k)
        return np.array(ids, np.int64), np.array(obs, np.int64)

    def _near(self, atm: Atm, ok, x0, rlat, ptop, pbot):
        """Count and kernel-weighted mass of the parcels that pass the
        JAX writer's tests for each observation (float64, [nobs])."""
        ctl = self.ctl
        dev = atm.time.device
        nobs = x0.shape[0]
        ids, obs = self._marked_cubes(x0)
        # Slot of each marked cube, and per slot the observations that
        # mark it, one layer of the table per multiplicity
        uniq, slot_of = np.unique(ids, return_inverse=True)
        order = np.argsort(slot_of, kind="stable")
        slots = slot_of[order]
        first = np.searchsorted(slots, np.arange(len(uniq)))
        rank = np.arange(len(slots)) - first[slots]
        layers = np.full((rank.max() + 1, len(uniq)), -1, np.int64)
        layers[rank, slots] = obs[order]
        table = torch.full((self.ncube ** 3,), -1, dtype=torch.int32,
                           device=dev)
        table[torch.as_tensor(uniq, device=dev)] = torch.arange(
            len(uniq), dtype=torch.int32, device=dev)
        # Hash of every parcel (float32), candidates in a marked cube
        g = self.ncube
        lat32 = float(_D2R) * atm.lat.to(torch.float32)
        lon32 = float(_D2R) * atm.lon.to(torch.float32)
        rcl = RE * torch.cos(lat32)
        cid = None
        for c in (rcl * torch.cos(lon32), rcl * torch.sin(lon32),
                  RE * torch.sin(lat32)):
            k = torch.clamp(torch.nan_to_num(torch.floor(
                (c - self.origin) / self.cube)), 0, g - 1).to(torch.int32)
            cid = k if cid is None else cid * g + k
        del lat32, lon32, rcl
        slot = table[cid.to(torch.int64)]
        del cid
        cand = torch.nonzero(ok & (slot >= 0)).flatten()
        slot = slot[cand].to(torch.int64)
        lat = atm.lat[cand].to(F64)
        x1 = _geo2cart_t(atm.lon[cand], atm.lat[cand])
        p = atm.p[cand]
        w = (kernel_weight_t(self.kz, self.kw, p) * atm.q["m"][cand].to(F64)
             if "m" in atm.q else None)
        p64 = p.to(F64)
        x0_t = torch.as_tensor(x0, dtype=F64, device=dev)
        rlat_t = torch.as_tensor(rlat, dtype=F64, device=dev)
        ptop_t = torch.as_tensor(ptop, dtype=F64, device=dev)
        pbot_t = torch.as_tensor(pbot, dtype=F64, device=dev)
        npts = torch.zeros(nobs + 1, dtype=torch.int64, device=dev)
        mass = torch.zeros(nobs + 1, dtype=F64, device=dev)
        for layer in layers:
            o = torch.as_tensor(layer, device=dev)[slot]
            valid = o >= 0
            oc = torch.clamp(o, 0)
            hit = valid & ((rlat_t[oc] - lat).abs() <= self.dlat)
            d2 = None
            for i in range(3):
                d = x1[i] - x0_t[oc, i]
                d2 = d * d if d2 is None else d2 + d * d
            hit &= d2 <= self.rmax2
            if ctl.sample_dz > 0:
                hit &= (p64 <= pbot_t[oc]) & (p64 >= ptop_t[oc])
            oi = torch.where(hit, oc, nobs)
            npts += torch.bincount(oi, minlength=nobs + 1)
            if w is not None:
                mass += _bin_sum(oi, w, nobs + 1)
        return npts[:nobs].cpu().numpy(), mass[:nobs].cpu().numpy()

    def write(self, metbuf, atm: Atm, t: float):
        ctl = self.ctl
        t0, t1 = t - 0.5 * ctl.dt_mod, t + 0.5 * ctl.dt_mod
        sel = np.nonzero((self.rt >= t0) & (self.rt < t1))[0]
        if sel.size == 0:
            return
        ok = _in_window(atm, t0, t1)
        x0 = _geo2cart(self.rlon[sel], self.rlat[sel])
        rp = _press(self.rz[sel])
        if ctl.sample_dz > 0:
            ptop = _press(self.rz[sel] + ctl.sample_dz)
            pbot = _press(self.rz[sel] - ctl.sample_dz)
        else:
            ptop = pbot = np.zeros(sel.size)
        npts, mass = self._near(atm, ok, x0, self.rlat[sel], ptop, pbot)
        if "m" not in atm.q:
            mass = np.zeros(sel.size)
        cd = mass / (1e6 * self.area)
        if ctl.molmass > 0 and ctl.sample_dz > 0:
            vmr = np.zeros(sel.size)
            pos = np.nonzero(mass > 0)[0]
            if pos.size:
                i = sel[pos]
                temp = _interp_met_t(metbuf, self.rt[i], rp[pos],
                                     self.rlon[i], self.rlat[i])
                vmr[pos] = (MA / ctl.molmass * cd[pos]
                            / (_rho(rp[pos], temp) * ctl.sample_dz * 1e3))
        else:
            vmr = np.full(sel.size, math.nan)
        for k, i in enumerate(sel.tolist()):
            self.out.write("%.2f %g %g %g %g %g %d %g %g %g\n" % (
                self.rt[i], self.rz[i], self.rlon[i], self.rlat[i],
                self.area, ctl.sample_dz, npts[k], cd[k], vmr[k],
                self.robs[i]))
        self.out.flush()

    def close(self):
        self.out.close()
