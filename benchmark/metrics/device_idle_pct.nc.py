"""``device_idle_pct`` in the cells fed from met files, which report
``parcel_steps_per_s.nc``: the same reading (``metrics/device_idle_pct.py``)."""

from benchmark.metrics_common import reader

read = reader("device_idle_pct")
