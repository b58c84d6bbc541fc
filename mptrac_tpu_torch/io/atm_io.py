"""Particle data I/O: ASCII / binary / netCDF atm files.

Counterpart of the JAX package's ``io/atm_io.py`` (reference
read_atm_asc mptrac.c:8056, write_atm_asc c:12450, read/write_atm_bin
c:8097, 12546, read/write_atm_nc c:8217, 12815).  ASCII format: columns
``time z[km] lon lat q...`` (z converted to pressure via the barometric
formula on read).  Files are read and written on the host with numpy;
``read_atm`` places the columns on ``device``, ``write_atm`` fetches
them.  The CLaMS particle files (types 3 and 4, read_atm_clams c:8154,
write_atm_clams c:12598) are netCDF files with an ``NPARTS`` dimension:
the JAX writer's bytes wherever the classic format (CDF-1) can hold
them, and the 64-bit-offset format (CDF-2) beyond that
(``clams_version``).
"""

from __future__ import annotations

import math
import struct
from typing import Optional

import numpy as np
import torch

from mptrac_tpu_torch.config import Ctl
from mptrac_tpu_torch.constants import H0, P0
from mptrac_tpu_torch.types import Atm, quantity_dtype, resolve_device


def read_atm(filename: str, ctl: Ctl, npmax: Optional[int] = None,
             dtype=torch.float64, device="cuda") -> Atm:
    """Read an atm file, dispatching on ATM_TYPE (reference
    mptrac_read_atm, c:6331): 0 ASCII, 1 binary, 2 netCDF, 3/4 CLaMS.
    ``dtype`` is the compute mode of positions and quantities."""
    dev = resolve_device(device)
    if ctl.atm_type == 0:
        cols, q = _read_atm_asc(filename, ctl)
    elif ctl.atm_type == 1:
        cols, q = _read_atm_bin(filename, ctl)
    elif ctl.atm_type == 2:
        cols, q = _read_atm_nc(filename, ctl)
    elif ctl.atm_type in (3, 4):
        cols, q = _read_atm_clams(filename, ctl)
    else:
        raise NotImplementedError(f"ATM_TYPE {ctl.atm_type}")
    n = cols[0].size
    npmax = npmax or n

    def col(a, dt=dtype):
        """The column on the device in ``dt``, zero-padded to the
        capacity; None (a quantity the file does not hold) gives
        zeros."""
        if a is None:
            return torch.zeros(npmax, dtype=dt, device=dev)
        if npmax != n:
            out = np.zeros(npmax)
            out[:n] = a
            a = out
        return torch.from_numpy(np.ascontiguousarray(a, np.float64)).to(
            dev).to(dt)

    time, p, lon, lat = cols
    # (the time keeps float64 in every compute mode: jsec values need it;
    # so does a parcel index)
    return Atm(time=col(time, torch.float64), p=col(p), lon=col(lon),
               lat=col(lat),
               q={name: col(q.get(name), quantity_dtype(name, dtype))
                  for name in ctl.qnt_name}, np=n)


def _read_atm_nc(filename: str, ctl: Ctl):
    """netCDF particle file with an ``obs`` dimension (reference
    read_atm_nc, c:8217)."""
    from mptrac_tpu_torch.io.hdf5 import open_netcdf_any
    v, nc = open_netcdf_any(filename)
    try:
        cols = [np.array(v[name][:], np.float64)
                for name in ("time", "press", "lon", "lat")]
        q = {name: np.array(v[name][:], np.float64)
             for name in ctl.qnt_name if name in v}
        return cols, q
    finally:
        if hasattr(nc, "close"):
            nc.close()


def _read_atm_clams(filename: str, ctl: Ctl):
    """CLaMS particle file with an ``NPARTS`` dimension (reference
    read_atm_clams, c:8154): the time from ``TIME_INIT`` or the file's
    ``time``; with ``ADVECT_VERT_COORD 1`` ``ZETA`` (to the quantity
    ``zeta``) and ``PRESS`` (else 500 hPa), otherwise the pressure from
    ``PRESS_INIT`` or ``PRESS``."""
    from mptrac_tpu_torch.io.hdf5 import open_netcdf_any
    v, nc = open_netcdf_any(filename)
    try:
        def col(name):
            return np.array(v[name][:], np.float64).ravel()

        lon, lat = col("LON"), col("LAT")
        n = lon.size
        if "TIME_INIT" in v:
            time = col("TIME_INIT")
        else:
            time = np.full(n, float(np.array(v["time"][:]).ravel()[0]))
        q = {}
        if ctl.advect_vert_coord == 1:
            zeta = col("ZETA")
            p = col("PRESS") if "PRESS" in v else np.full(n, 500.0)
            if "zeta" in ctl.qnt_name:
                q["zeta"] = zeta
        else:
            p = col("PRESS_INIT" if "PRESS_INIT" in v else "PRESS")
        for name in ctl.qnt_name:
            if name not in q and name in v:
                q[name] = col(name)
        return [time, p, lon, lat], q
    finally:
        if hasattr(nc, "close"):
            nc.close()


def _read_atm_asc(filename: str, ctl: Ctl):
    rows = []
    with open(filename) as f:
        for line in f:
            toks = line.split()
            if len(toks) < 4:
                continue
            try:
                vals = [float(x) for x in toks[:4 + ctl.nq]]
            except ValueError:
                continue
            rows.append(vals)
    if not rows:
        raise ValueError(f"No air parcels in {filename}")
    data = np.array(rows, np.float64)
    q = {name: data[:, 4 + iq] for iq, name in enumerate(ctl.qnt_name)
         if data.shape[1] > 4 + iq}
    return [data[:, 0], P0 * np.exp(-data[:, 1] / H0), data[:, 2],
            data[:, 3]], q


def _read_atm_bin(filename: str, ctl: Ctl):
    """Binary atm container, version 100 (reference read_atm_bin,
    c:8097)."""
    with open(filename, "rb") as f:
        version, = struct.unpack("<i", f.read(4))
        if version != 100:
            raise ValueError("Wrong version of binary data!")
        n, = struct.unpack("<i", f.read(4))

        def arr():
            a = np.fromfile(f, "<f8", n)
            if a.size != n:
                raise ValueError("Error while reading binary data!")
            return a
        cols = [arr() for _ in range(4)]
        q = {name: arr() for name in ctl.qnt_name}
        final, = struct.unpack("<i", f.read(4))
        if final != 999:
            raise ValueError("Error while reading binary data!")
    return cols, q


def _n(t: torch.Tensor, n: int) -> np.ndarray:
    """The first ``n`` values of a column on the host."""
    return t[:n].detach().cpu().numpy()


def write_atm(filename: str, ctl: Ctl, atm: Atm, t: float) -> None:
    """Dispatch on ATM_TYPE_OUT (reference mptrac_write_atm, c:7806):
    0 ASCII, 1 binary, 2 netCDF, 3/4 CLaMS."""
    if ctl.atm_type_out == 0:
        write_atm_asc(filename, ctl, atm, t)
    elif ctl.atm_type_out == 1:
        write_atm_bin(filename, ctl, atm)
    elif ctl.atm_type_out == 2:
        write_atm_nc(filename, ctl, atm)
    elif ctl.atm_type_out in (3, 4):
        write_atm_clams(filename, ctl, atm)
    else:
        raise NotImplementedError(f"ATM_TYPE_OUT {ctl.atm_type_out}")


def write_atm_nc(filename: str, ctl: Ctl, atm: Atm) -> None:
    """netCDF particle file (reference write_atm_nc, c:12815)."""
    from scipy.io import netcdf_file
    n = int(atm.np)
    nc = netcdf_file(filename, "w")
    try:
        nc.createDimension("obs", n)
        for name, data, unit in (
                ("time", _n(atm.time, n),
                 b"seconds since 2000-01-01 00:00:00 UTC"),
                ("press", _n(atm.p, n), b"hPa"),
                ("lon", _n(atm.lon, n), b"degrees_east"),
                ("lat", _n(atm.lat, n), b"degrees_north")):
            v = nc.createVariable(name, "d", ("obs",))
            v[:] = data
            v.units = unit
        for iq, name in enumerate(ctl.qnt_name):
            v = nc.createVariable(name, "d", ("obs",))
            v[:] = _n(atm.q[name], n)
            v.units = ctl.qnt_unit[iq].encode()
        nc.featureType = b"point"
    finally:
        nc.close()


#: largest begin offset of a variable in a CDF-1 file (scipy packs it
#: as a signed 32-bit integer)
CDF1_MAX_BEGIN = 2 ** 31 - 1


def _clams_layout(nc, n: int, ctl: Ctl) -> None:
    """Dimensions, variables and attributes of a CLaMS particle file,
    in the JAX writer's order (data left unset)."""
    nc.createDimension("time", 1)
    nc.createDimension("NPARTS", n)
    nc.createVariable("time", "d", ("time",))
    for name in ("LAT", "LON", "PRESS", "ZETA"):
        nc.createVariable(name, "d", ("NPARTS",))
    for name in ctl.qnt_name:
        if name != "zeta":
            nc.createVariable(name, "d", ("NPARTS",))
    nc.exp_VERTCOOR_name = b"zeta"
    nc.model = b"MPTRAC"


def clams_begins(n: int, ctl: Ctl) -> dict:
    """{variable: begin offset} of a CLaMS particle file of ``n``
    parcels as scipy lays it out: the header (whose length does not
    depend on ``n``), then the variables, the ``NPARTS`` ones first."""
    import io

    from scipy.io import netcdf_file
    buf = io.BytesIO()
    nc = netcdf_file(buf, "w")
    _clams_layout(nc, 1, ctl)
    names = list(nc.variables)
    nc.flush()
    header = len(buf.getvalue()) - 8 * len(names)
    nc.close()
    sizes = {name: 8 * (1 if name == "time" else n) for name in names}
    # scipy's order: by shape, largest first, stable
    order = sorted(names, key=sizes.get, reverse=True)
    begins, pos = {}, header
    for name in order:
        begins[name] = pos
        pos += sizes[name]
    return begins


def clams_version(n: int, ctl: Ctl) -> int:
    """The netCDF format of a CLaMS particle file of ``n`` parcels: 1,
    the classic format that the JAX writer always writes, while every
    variable begins below 2 GiB; 2 (64-bit offsets) beyond, where the
    JAX writer fails (at 100,663,296 parcels ``ZETA`` begins at 2.4e9
    B)."""
    return 1 if max(clams_begins(n, ctl).values()) <= CDF1_MAX_BEGIN else 2


def write_atm_clams(filename: str, ctl: Ctl, atm: Atm) -> None:
    """CLaMS position file (reference write_atm_clams, c:12598): the JAX
    writer's file in ``clams_version``'s format."""
    from scipy.io import netcdf_file
    n = int(atm.np)
    nc = netcdf_file(filename, "w", version=clams_version(n, ctl))
    try:
        _clams_layout(nc, n, ctl)
        var = nc.variables
        var["time"][:] = [float(atm.time[0]) if n else 0.0]
        for name, col in (("LAT", atm.lat), ("LON", atm.lon),
                          ("PRESS", atm.p)):
            var[name][:] = _n(col, n)
        var["ZETA"][:] = (_n(atm.q["zeta"], n) if "zeta" in atm.q
                          else np.zeros(n))
        for name in ctl.qnt_name:
            if name != "zeta":
                var[name][:] = _n(atm.q[name], n)
    finally:
        nc.close()


def _gnuplot_pipe(gpfile: str, filename: str, t: float):
    """Open a pipe into gnuplot with the reference's prelude: output
    PNG name + timestr variable + the user's plot script
    (write_atm_asc gnuplot branch, c:12462-12486)."""
    import subprocess

    from mptrac_tpu_torch.timeutil import jsec2time

    try:
        proc = subprocess.Popen(["gnuplot"], stdin=subprocess.PIPE,
                                text=True)
    except FileNotFoundError:
        raise RuntimeError("Cannot create pipe to gnuplot!")
    year, mon, day, hour, minute, _, _ = jsec2time(t)
    proc.stdin.write(f'set out "{filename}.png"\n')
    proc.stdin.write(f'timestr="{year}-{mon:02d}-{day:02d}, '
                     f'{hour:02d}:{minute:02d} UTC"\n')
    with open(gpfile) as f:
        proc.stdin.write(f.read())
    return proc


class _PipeCtx:
    def __init__(self, proc):
        self.proc = proc

    def __enter__(self):
        return self.proc.stdin

    def __exit__(self, *exc):
        self.proc.stdin.close()
        self.proc.wait()
        return False


def write_atm_asc(filename: str, ctl: Ctl, atm: Atm, t: float) -> None:
    """ASCII particle table (reference write_atm_asc, c:12450),
    byte-compatible with the reference format.  With ATM_GPFILE set,
    the table is piped into gnuplot instead (c:12462)."""
    n = int(atm.np)
    time = _n(atm.time, n)
    p = _n(atm.p, n)
    lon = _n(atm.lon, n)
    lat = _n(atm.lat, n)
    qs = [_n(atm.q[name], n) for name in ctl.qnt_name]
    z = H0 * np.log(P0 / p)

    t0 = t - 0.5 * ctl.dt_mod
    t1 = t + 0.5 * ctl.dt_mod

    if ctl.atm_gpfile != "-":
        sink = _PipeCtx(_gnuplot_pipe(ctl.atm_gpfile, filename, t))
    else:
        sink = open(filename, "w")
    with sink as out:
        if ctl.met_coord_type == 0:
            out.write("# $1 = time [s]\n# $2 = altitude [km]\n"
                      "# $3 = longitude [deg]\n# $4 = latitude [deg]\n")
        else:
            out.write("# $1 = time [s]\n# $2 = altitude [km]\n"
                      "# $3 = x [m]\n# $4 = y [m]\n")
        for iq in range(ctl.nq):
            out.write(f"# ${iq + 5} = {ctl.qnt_name[iq]} "
                      f"[{ctl.qnt_unit[iq]}]\n")
        out.write("\n")
        for ip in range(0, n, ctl.atm_stride):
            if ctl.atm_filter == 2 and (time[ip] < t0 or time[ip] > t1):
                continue
            if ctl.met_coord_type == 0:
                out.write("%.2f %g %g %g" % (time[ip], z[ip],
                                             lon[ip], lat[ip]))
            else:
                out.write("%.2f %g %.2f %.2f" % (time[ip], z[ip],
                                                 lon[ip], lat[ip]))
            for iq in range(ctl.nq):
                val = qs[iq][ip]
                if ctl.atm_filter == 1 and (time[ip] < t0 or time[ip] > t1):
                    val = math.nan
                out.write(" " + ctl.qnt_format[iq] % val)
            out.write("\n")


def write_atm_bin(filename: str, ctl: Ctl, atm: Atm) -> None:
    """Binary atm container version 100 (reference write_atm_bin,
    c:12546).  One column at a time crosses to the host."""
    n = int(atm.np)
    with open(filename, "wb") as out:
        out.write(struct.pack("<i", 100))
        out.write(struct.pack("<i", n))
        for arrname in ("time", "p", "lon", "lat"):
            _n(getattr(atm, arrname), n).astype("<f8", copy=False).tofile(out)
        for name in ctl.qnt_name:
            _n(atm.q[name], n).astype("<f8", copy=False).tofile(out)
        out.write(struct.pack("<i", 999))
