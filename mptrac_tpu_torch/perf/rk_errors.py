#!/usr/bin/env python3
"""K1 (``ops.rk_fused.advect_all``) against its plain version, by latitude.

On the small tilted solid-body wind of the card tests (36x19x8, the
rotation axis 30 deg off the pole, a vertical wind), parcels are drawn
over the whole globe and, as many again, within 10 deg of the poles, with
dt 180 s.  For every RK scheme the script prints one JSON line with the
largest differences of the new position between the kernel and
``rk_plain``, per band of the start latitude: longitude in degrees, the
same as a distance along the parallel (times the cosine of the start
latitude, which the zonal step divides by; ``lon_distance_end`` with the
end latitude's), latitude and pressure.  A zonal step grows as
1 / cos(lat), so near a pole a rounding of the wind or of the latitude
is magnified in longitude but not in distance.

Usage: python -m mptrac_tpu_torch.perf.rk_errors [--n N] [--device cuda|cpu]

Run as a file with another checkout's package first on ``PYTHONPATH``, it
measures that checkout's kernel on the same parcels.  On the CPU both sides
are the plain version and every difference is 0.
"""

from __future__ import annotations

import argparse
import json
import math
import sys

import torch

import mptrac_tpu_torch
from mptrac_tpu_torch.met.synthetic import make_wind_met
from mptrac_tpu_torch.ops import rk_fused
from mptrac_tpu_torch.types import resolve_device, stack_met

#: bands of |start latitude| in degrees
BANDS = ((0.0, 60.0), (60.0, 80.0), (80.0, 89.0), (89.0, 90.0))


def make_case(n, dev, seed=5):
    """(pack, (lon, lat, p, dt, wt0)): the card tests' met pair and n
    parcels over the globe plus n within 10 deg of the poles."""
    snaps = [make_wind_met(t, nx=36, ny=19, nz=8, alpha=30.0, w0=0.1,
                           temp0=200.0, temp1=290.0 + t / 3600.0,
                           device=dev) for t in (0.0, 3600.0)]
    pack = rk_fused.build_cell_pack(stack_met(*snaps))
    gen = torch.Generator(device=dev).manual_seed(seed)

    def u(lo, hi, k):
        return lo + (hi - lo) * torch.rand(k, device=dev, generator=gen)

    lo_p, hi_p = float(pack.p_axis.min()), float(pack.p_axis.max())
    polar = u(80.0, 90.0, n) * torch.where(
        torch.rand(n, device=dev, generator=gen) < 0.5, -1.0, 1.0)
    lat = torch.cat([u(-90.0, 90.0, n), polar])
    lon = u(-20.0, 380.0, 2 * n)
    p = u(lo_p, hi_p, 2 * n)
    dt = torch.full((2 * n,), 180.0, device=dev)
    wt0 = torch.rand(2 * n, device=dev, generator=gen)
    return pack, (lon, lat, p, dt, wt0)


def band_errors(got, exp, lat0):
    """{band: largest |got - exp| of lon, lon as a distance, lat, p}."""
    out = {}
    cos_end = torch.cos(exp[1].double() * (math.pi / 180.0)).abs()
    cos_start = torch.cos(lat0.double() * (math.pi / 180.0)).abs()
    for lo, hi in BANDS:
        sel = (lat0.abs() >= lo) & (lat0.abs() <= hi)
        row = {"parcels": int(sel.sum())}
        for key, r in (("lon", 0), ("lat", 1), ("p", 2)):
            d = (got[r][sel].double() - exp[r][sel].double()).abs()
            row[key] = float(d.max()) if d.numel() else 0.0
            if r == 0:
                for name, c in (("lon_distance", cos_start),
                                ("lon_distance_end", cos_end)):
                    row[name] = (float((d * c[sel]).max()) if d.numel()
                                 else 0.0)
        out[f"{lo:g}-{hi:g}"] = row
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="K1 against its plain version, by latitude band")
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    pack, case = make_case(args.n, dev)
    print(f"package={mptrac_tpu_torch.__file__} device="
          f"{torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu'}",
          file=sys.stderr)
    for nstage in (1, 2, 4):
        got = rk_fused.advect_all(pack, nstage, *case)[0]
        exp = rk_fused.rk_plain(pack, nstage, *case)
        print(json.dumps({"nstage": nstage,
                          "bands": band_errors(got, exp, case[1])}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
