"""wind — generate synthetic meteorological data files
(reference src/wind.c).

Usage: python -m mptrac_tpu_torch.tools.wind <ctl> <metbase>
       [KEY VALUE ...]

Writes a solid-body-rotation wind field (WIND_U0/U1, tilt WIND_ALPHA,
vertical velocity WIND_W0, grid WIND_NX/NY/NZ over WIND_Z0..Z1) as a
netCDF met file for advection and domain-decomposition tests.  The
fields are made on the host.
"""

from __future__ import annotations

import sys

from mptrac_tpu_torch.config import CtlFile, read_ctl
from mptrac_tpu_torch.timeutil import jsec2time
from mptrac_tpu_torch.tools._cli import require_args, run_tool


def main(argv):
    require_args(argv, 3, "wind <ctl> <metbase> [KEY VALUE ...]")
    read_ctl(argv[1], argv[2:])
    s = CtlFile(argv[1], argv[2:])
    g = s.scan_float
    t0 = g("WIND_T0", -1, "0")
    nx = int(g("WIND_NX", -1, "360"))
    ny = int(g("WIND_NY", -1, "181"))
    nz = int(g("WIND_NZ", -1, "61"))
    z0 = g("WIND_Z0", -1, "0")
    z1 = g("WIND_Z1", -1, "60")
    u0 = g("WIND_U0", -1, "38.587660177302")
    u1 = g("WIND_U1", -1, "38.587660177302")
    w0 = g("WIND_W0", -1, "0")
    alpha = g("WIND_ALPHA", -1, "0.0")
    temp0 = g("WIND_TEMP0", -1, "280")
    temp1 = g("WIND_TEMP1", -1, "280")
    ps = g("WIND_PS", -1, "1013.25")
    zs = g("WIND_ZS", -1, "0")
    blh = g("WIND_BLH", -1, "1.0")

    from mptrac_tpu_torch.met.synthetic import make_wind_met
    from mptrac_tpu_torch.met.write_nc import write_met_nc
    # make_wind_met adds the periodic wrap column itself; pass nx as-is
    met = make_wind_met(t0=t0, nx=nx, ny=ny, nz=nz, z0=z0, z1=z1, u0=u0,
                        u1=u1, w0=w0, alpha=alpha, temp0=temp0,
                        temp1=temp1, ps=ps, zs=zs, blh=blh, device="cpu")
    year, mon, day, hour, _, _, _ = jsec2time(t0)
    fn = f"{argv[2]}_{year:d}_{mon:02d}_{day:02d}_{hour:02d}.nc"
    write_met_nc(fn, met, drop_wrap_column=True)
    print(f"Wrote {fn}")
    return 0


if __name__ == "__main__":
    sys.exit(run_tool(main))
