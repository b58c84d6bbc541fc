"""The solid-body met of MPTRAC's ``wind`` tool: the met generator that
a configuration uses where it names none.

* ``snapshots(grid, met, times)``: one snapshot ``(lon, lat, p,
  fields2d, fields3d)`` for each time, from the configuration's
  ``grid`` and ``met`` parameters (the flow is steady: one snapshot
  serves every time);
* ``series(directory, grid, met, dt_met, nfiles)``: the hourly series of
  the file cells, written once into ``directory``; its base name;
* ``filename(base, t)``: the file of time ``t`` in that series;
* ``FORMAT``, ``CTL``: the format of those files (netCDF), and the
  control parameters with which the program reads them (``MET_TYPE
  0``).

The code is ``inputs.py``'s (``wind_met``, ``met_series``,
``write_met_nc``, ``met_filename``).
"""

from benchmark import inputs

FORMAT = "netcdf"
CTL = ("MET_TYPE", "0")


def snapshots(grid: dict, met: dict, times) -> list:
    snap = inputs.wind_met(grid["nx"], grid["ny"], grid["nz"], **met)
    return [snap for _ in times]


series = inputs.met_series
filename = inputs.met_filename
