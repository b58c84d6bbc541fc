"""plot — render particle/grid/met outputs
(reference projects/python/plot_atm.py, plot_traj.py, plot_grid.py,
plot_met_map.py).

Usage: python -m mptrac_tpu_torch.tools.plot <kind> <out.png>
       <files...> [options]

kinds:
  atm      scatter map of particle positions colored by altitude
           (one png per input atm file when <out.png> contains '{}')
  traj     trajectories from a sequence of atm files
  grid     column density map from a grid output file
  met_map  temperature map from a met_map output table

options: --proj cartesian|robinson|orthographic, --bounds LON0 LON1 LAT0
LAT1, --zrange ZMIN ZMAX, --mark LON LAT.  Numpy and matplotlib on the
host; matplotlib is imported when a plot is drawn.
"""

from __future__ import annotations

import sys

import numpy as np

from mptrac_tpu_torch.tools._cli import require_args, run_tool


def _load_tab(path):
    rows = []
    with open(path) as f:
        for line in f:
            toks = line.split()
            if not toks or toks[0].startswith("#"):
                continue
            rows.append([float(x) for x in toks])
    return np.array(rows)


def main(argv):
    require_args(argv, 4, "plot <kind> <out.png> <files...>")
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    kind = argv[1]
    out = argv[2]
    # options after the file list (web runner plot settings; the
    # reference renders these with cartopy, app.py:265-313; here the
    # Robinson/orthographic transforms are plain numpy)
    files = []
    proj = "cartesian"
    bounds = None
    zrange = None
    mark = None
    it = iter(argv[3:])
    for a in it:
        if a == "--proj":
            proj = next(it)
        elif a == "--bounds":
            bounds = [float(next(it)) for _ in range(4)]
        elif a == "--zrange":
            zrange = [float(next(it)) for _ in range(2)]
        elif a == "--mark":
            mark = [float(next(it)) for _ in range(2)]
        else:
            files.append(a)

    def project(lon, lat):
        lon = np.asarray(lon, float)
        lat = np.asarray(lat, float)
        if proj == "robinson":
            # Robinson by table interpolation (standard coefficients)
            latt = np.array([0, 5, 10, 15, 20, 25, 30, 35, 40, 45, 50,
                             55, 60, 65, 70, 75, 80, 85, 90])
            X = np.array([1, .9986, .9954, .99, .9822, .973, .96,
                          .9427, .9216, .8962, .8679, .835, .7986,
                          .7597, .7186, .6732, .6213, .5722, .5322])
            Y = np.array([0, .062, .124, .186, .248, .31, .372, .434,
                          .4958, .5571, .6176, .6769, .7346, .7903,
                          .8435, .8936, .9394, .9761, 1])
            x = (np.interp(np.abs(lat), latt, X) * lon / 180.0)
            y = np.sign(lat) * np.interp(np.abs(lat), latt, Y)
            return x, y, None
        if proj == "orthographic":
            lam = np.radians(lon - (mark[0] if mark else 0.0))
            phi = np.radians(lat)
            phi0 = np.radians(mark[1] if mark else 0.0)
            cosc = (np.sin(phi0) * np.sin(phi)
                    + np.cos(phi0) * np.cos(phi) * np.cos(lam))
            x = np.cos(phi) * np.sin(lam)
            y = (np.cos(phi0) * np.sin(phi)
                 - np.sin(phi0) * np.cos(phi) * np.cos(lam))
            return x, y, cosc >= 0          # visible hemisphere
        return lon, lat, None

    if kind == "atm":
        for i, f in enumerate(files):
            d = _load_tab(f)
            fig, ax = plt.subplots(figsize=(10, 5))
            x, y, vis = project(d[:, 2], d[:, 3])
            z = d[:, 1]
            if vis is not None:
                x, y, z = x[vis], y[vis], z[vis]
            kw = {}
            if zrange:
                kw = dict(vmin=zrange[0], vmax=zrange[1])
            sc = ax.scatter(x, y, c=z, s=2, cmap="viridis", **kw)
            fig.colorbar(sc, ax=ax, label="altitude [km]")
            if mark is not None:
                mx, my, mvis = project([mark[0]], [mark[1]])
                if mvis is None or mvis[0]:
                    ax.plot(mx, my, "o", color="red", ms=8,
                            mec="white", zorder=5)
            if proj == "cartesian":
                ax.set_xlabel("longitude [deg]")
                ax.set_ylabel("latitude [deg]")
                if bounds:
                    ax.set_xlim(bounds[0], bounds[1])
                    ax.set_ylim(bounds[2], bounds[3])
            else:
                ax.set_aspect("equal")
                ax.set_xticks([])
                ax.set_yticks([])
                if proj == "orthographic":
                    th = np.linspace(0, 2 * np.pi, 200)
                    ax.plot(np.cos(th), np.sin(th), color="gray",
                            lw=0.5)
            ax.set_title(f)
            fn = out.format(i) if "{}" in out or "{0}" in out else (
                out if len(files) == 1 else f"{out}.{i}.png")
            fig.savefig(fn, dpi=120)
            plt.close(fig)
    elif kind == "traj":
        fig, ax = plt.subplots(figsize=(10, 5))
        data = [_load_tab(f) for f in files]
        nmin = min(d.shape[0] for d in data)
        lon = np.stack([d[:nmin, 2] for d in data])
        lat = np.stack([d[:nmin, 3] for d in data])
        step = max(1, nmin // 500)
        ax.plot(lon[:, ::step], lat[:, ::step], lw=0.5, alpha=0.6)
        ax.set_xlabel("longitude [deg]")
        ax.set_ylabel("latitude [deg]")
        fig.savefig(out, dpi=120)
        plt.close(fig)
    elif kind == "grid":
        d = _load_tab(files[0])
        lon = np.unique(d[:, 2])
        lat = np.unique(d[:, 3])
        cd = np.full((lat.size, lon.size), np.nan)
        ilon = np.searchsorted(lon, d[:, 2])
        ilat = np.searchsorted(lat, d[:, 3])
        cd[ilat, ilon] = d[:, 6]
        fig, ax = plt.subplots(figsize=(10, 5))
        pm = ax.pcolormesh(lon, lat, cd, cmap="magma")
        fig.colorbar(pm, ax=ax, label="column density [kg/m^2]")
        ax.set_xlabel("longitude [deg]")
        ax.set_ylabel("latitude [deg]")
        fig.savefig(out, dpi=120)
        plt.close(fig)
    elif kind == "met_map":
        d = _load_tab(files[0])
        lon = np.unique(d[:, 2])
        lat = np.unique(d[:, 3])
        tt = np.full((lat.size, lon.size), np.nan)
        ilon = np.searchsorted(lon, d[:, 2])
        ilat = np.searchsorted(lat, d[:, 3])
        tt[ilat, ilon] = d[:, 5]
        fig, ax = plt.subplots(figsize=(10, 5))
        pm = ax.pcolormesh(lon, lat, tt, cmap="coolwarm")
        fig.colorbar(pm, ax=ax, label="temperature [K]")
        fig.savefig(out, dpi=120)
        plt.close(fig)
    else:
        raise SystemExit(f"Unknown plot kind: {kind}")
    return 0


if __name__ == "__main__":
    sys.exit(run_tool(main))
