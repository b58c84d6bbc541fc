"""met_spec — zonal spectral analysis of meteo fields
(reference src/met_spec.c, fft_help c:2562).

Usage: python -m mptrac_tpu_torch.tools.met_spec <ctl> <spec.tab> <met>
       [KEY VALUE ...] [--device cuda|cpu]

Fourier-decomposes temperature along each latitude circle at every
level and writes wavenumber amplitude/phase spectra.
"""

from __future__ import annotations

import sys

import numpy as np

from mptrac_tpu_torch.climatology import read_clim
from mptrac_tpu_torch.config import CtlFile, read_ctl
from mptrac_tpu_torch.constants import H0, P0
from mptrac_tpu_torch.met.build import read_met
from mptrac_tpu_torch.tools._cli import pop_device, require_args, run_tool


_USAGE = ("met_spec <ctl> <spec.tab> <met> [KEY VALUE ...] "
          "[--device cuda|cpu]")


def main(argv):
    argv = list(argv)
    device = pop_device(argv, _USAGE)
    require_args(argv, 4, _USAGE)
    ctl = read_ctl(argv[1], argv[2:])
    s = CtlFile(argv[1], argv[2:])
    wmax = int(s.scan_float("SPEC_WAVEMAX", -1, "7"))
    clim = read_clim(ctl, device=device)
    met = read_met(argv[3], ctl, clim, device=device)

    lat = met.lat.cpu().numpy()
    p = met.p.cpu().numpy()
    t3 = met.fields3d["t"].cpu().numpy().astype(np.float64)
    # drop the duplicated wraparound column before the FFT
    nx = met.nx - 1 if abs(float(met.lon[-1] - met.lon[0]) - 360.0) \
        < 0.01 else met.nx
    spec = np.fft.rfft(t3[:nx], axis=0) / nx       # [kmax+1, ny, np]

    with open(argv[2], "w") as out:
        out.write("# $1 = time [s]\n# $2 = altitude [km]\n"
                  "# $3 = latitude [deg]\n# $4 = wavenumber [1]\n"
                  "# $5 = amplitude [K]\n# $6 = phase [deg]\n")
        for iz in range(p.size):
            for iy in range(lat.size):
                out.write("\n")
                for k in range(min(wmax, spec.shape[0] - 1) + 1):
                    c = spec[k, iy, iz]
                    amp = (np.abs(c) if k == 0 else 2 * np.abs(c))
                    out.write("%.2f %g %g %d %g %g\n" % (
                        float(met.time), H0 * np.log(P0 / p[iz]),
                        lat[iy], k, amp, np.rad2deg(np.angle(c))))
    return 0


if __name__ == "__main__":
    sys.exit(run_tool(main))
