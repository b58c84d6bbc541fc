"""Helpers of the tests/test_torch_*.py files: JAX pytrees of the
reference package to the plain numpy dicts that
``mptrac_tpu_torch.convert`` takes, and a shared small flagship state.

The port never imports JAX; these helpers do the ``np.asarray``.
"""

import numpy as np


def atm_to_numpy(atm):
    return dict(time=np.asarray(atm.time), p=np.asarray(atm.p),
                lon=np.asarray(atm.lon), lat=np.asarray(atm.lat),
                q={k: np.asarray(v) for k, v in atm.q.items()},
                np=int(atm.np))


def cache_to_numpy(cache):
    return dict(uvwp=np.asarray(cache.uvwp), dt=np.asarray(cache.dt),
                rng_ctr=int(cache.rng_ctr),
                iso_var=np.asarray(cache.iso_var),
                iso_ps=np.asarray(cache.iso_ps),
                iso_ts=np.asarray(cache.iso_ts), iso_n=int(cache.iso_n),
                served_min=(None if cache.served_min is None
                            else float(cache.served_min)))


def met_to_numpy(met):
    return dict(time=np.asarray(met.time), lon=np.asarray(met.lon),
                lat=np.asarray(met.lat), p=np.asarray(met.p),
                hybrid=np.asarray(met.hybrid),
                fields2d={k: np.asarray(v)
                          for k, v in met.fields2d.items()},
                fields3d={k: np.asarray(v)
                          for k, v in met.fields3d.items()},
                coord_type=met.coord_type, npl_ml=met.npl_ml,
                reg_lon=met.reg_lon, reg_lat=met.reg_lat,
                lon_periodic=met.lon_periodic)


def clim_to_numpy(clim):
    """The full Clim: tropopause, photolysis, zonal means, time series."""
    return dict(tropo_time=np.asarray(clim.tropo_time),
                tropo_lat=np.asarray(clim.tropo_lat),
                tropo=np.asarray(clim.tropo),
                photo_p=np.asarray(clim.photo_p),
                photo_sza=np.asarray(clim.photo_sza),
                photo_o3c=np.asarray(clim.photo_o3c),
                photo={k: np.asarray(v) for k, v in clim.photo.items()},
                zm={k: dict(time=np.asarray(z.time), lat=np.asarray(z.lat),
                            p=np.asarray(z.p), vmr=np.asarray(z.vmr))
                    for k, z in clim.zm.items()},
                ts={k: dict(time=np.asarray(s.time), vmr=np.asarray(s.vmr))
                    for k, s in clim.ts.items()})


def to_torch(atm=None, cache=None, met01=None, clim=None):
    """Reference pytrees -> the port's dataclasses on the CPU."""
    from mptrac_tpu_torch.convert import from_reference
    return from_reference(
        None if atm is None else atm_to_numpy(atm),
        None if cache is None else cache_to_numpy(cache),
        None if met01 is None else met_to_numpy(met01),
        None if clim is None else clim_to_numpy(clim),
        device="cpu")


def small_flagship_fp32(n=2048, nx=36, ny=19, nz=8):
    """The reference flagship at the size of tests/test_rk_fused.py, in
    fp32 compute mode: (ctl, clim, met01, atm, cache) of the JAX
    package."""
    import __graft_entry__ as g
    from mptrac_tpu.types import astype_state
    ctl, clim, met01, atm, cache = g._make_setup(n, nx=nx, ny=ny, nz=nz)
    atm, cache, met01, clim = astype_state(atm, cache, met01, clim)
    return ctl, clim, met01, atm, cache
