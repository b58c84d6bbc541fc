"""Calendar utilities.

The MPTRAC time coordinate ("Julian seconds", jsec) is seconds since
2000-01-01 00:00:00 UTC (reference mptrac.c:12283
``time2jsec`` and c:3265 ``jsec2time``).  Host-side Python; times inside
jitted code are plain float64 scalars/arrays.
"""

import datetime

_EPOCH = datetime.datetime(2000, 1, 1, tzinfo=datetime.timezone.utc)


def time2jsec(year: int, mon: int, day: int, hour: int = 0, min: int = 0,
              sec: int = 0, remain: float = 0.0) -> float:
    """Calendar date (UTC) -> seconds since 2000-01-01T00:00Z."""
    t = datetime.datetime(year, mon, day, hour, min, sec,
                          tzinfo=datetime.timezone.utc)
    return (t - _EPOCH).total_seconds() + remain


def jsec2time(jsec: float):
    """Seconds since 2000-01-01T00:00Z -> (year, mon, day, hour, min, sec, remain)."""
    import math
    t = _EPOCH + datetime.timedelta(seconds=int(jsec))
    return (t.year, t.month, t.day, t.hour, t.minute, t.second,
            jsec - math.floor(jsec))


def day2doy(year: int, mon: int, day: int) -> int:
    """Calendar date -> day of year (reference src/day2doy.c)."""
    return datetime.date(year, mon, day).timetuple().tm_yday


def doy2day(year: int, doy: int):
    """Day of year -> (mon, day) (reference src/doy2day.c)."""
    d = datetime.date(year, 1, 1) + datetime.timedelta(days=doy - 1)
    return d.month, d.day


def sec2season(jsec: float) -> float:
    """Seconds since begin of (365.25-day) year, as used by the
    climatological tropopause lookup (reference mptrac.c:213-222)."""
    year_s = 365.25 * 86400.0
    sec = jsec - int(jsec / year_s) * year_s
    while sec < 0:
        sec += year_s
    return sec
