"""The driver that a workload uses where it names none: one
``Simulation`` of the program on one card (or the CPU in the tests),
its state in float32.

The program under test is ``mptrac_tpu_torch``, driven through its own
entry points: ``config.read_ctl``, ``types.Atm`` / ``Cache`` / ``Met``,
``sim.Simulation`` with ``sim.FixedMet`` (met in memory) or its default
``sim.MetBuffer`` (the met files of ``METBASE``), and
``Simulation.advance`` step by step (the run loop of ``Simulation.run``:
sort when due, met swap, ``pipeline.run_timestep``).

What the harness takes from a driver (``Driver``): set-up in the
constructor, ``ctl``, ``swap_due``, ``step``, ``sync``, ``hook_sort`` /
``unhook_sort``, ``take``, ``met_pair``, ``met_reads``, ``peak_bytes``
and ``close``.
"""

from __future__ import annotations

from typing import Callable, ContextManager, List, Optional

import numpy as np
import torch

from benchmark import checks, inputs
from benchmark.manifest import RunError


def _program_met(arrays, t0: float, device):
    from mptrac_tpu_torch.types import Met, _axis_is_arithmetic
    lon, lat, p, f2, f3 = arrays

    def axis(a):
        return torch.from_numpy(np.asarray(a, np.float64)).to(device)

    def fld(a):
        return torch.from_numpy(a).to(device)

    return Met(time=float(t0), lon=axis(lon), lat=axis(lat), p=axis(p),
               hybrid=torch.zeros(p.size, dtype=torch.float64,
                                  device=device),
               fields2d={k: fld(v) for k, v in f2.items()},
               fields3d={k: fld(v) for k, v in f3.items()}, coord_type=0,
               npl_ml=0, reg_lon=_axis_is_arithmetic(lon),
               reg_lat=_axis_is_arithmetic(lat), lon_periodic=True)


class Driver:
    """The program's state and ``Simulation`` of one cell on ``device``:
    ``cfg`` and ``wl`` the configuration and workload, ``args`` the
    control parameters (``KEY VALUE``), ``snaps`` the met snapshots at
    the pair's two times (met in memory; None: the program reads the met
    files that ``args`` name), ``seed`` the run's seed."""

    def __init__(self, cfg: dict, wl: dict, args: List[str],
                 snaps: Optional[list], seed: int, device: torch.device):
        if cfg["dtype"] != "float32":
            raise RunError(f"the driver single runs float32, the "
                           f"configuration states {cfg['dtype']}")
        if wl["chips"] != 1:
            raise RunError(f"the driver single runs on one card, the cell "
                           f"asks for {wl['chips']}")
        self.device = dev = device
        if dev.type == "cuda":
            torch.cuda.set_device(0)
            torch.cuda.reset_peak_memory_stats(dev)

        from mptrac_tpu_torch import config as p_config
        from mptrac_tpu_torch import sim as p_sim
        from mptrac_tpu_torch.climatology import read_clim
        from mptrac_tpu_torch.types import (Atm, Cache, astype_state,
                                            stack_met)
        from mptrac_tpu_torch.utils import log as p_log

        if dev.type == "cuda":
            from mptrac_tpu_torch.ops import _cuda
            _cuda.load()             # builds the kernels on a first run
        self._sim_module = p_sim
        n = int(cfg["n_parcels"])
        p_log.set_level(0)
        ctl = p_config.read_ctl(None, args)
        clim = read_clim(ctl, device=dev)
        f32 = torch.float32
        if snaps is not None:
            dt_met = float(wl["met"]["dt_met"])
            pair = stack_met(_program_met(snaps[0], 0.0, dev),
                             _program_met(snaps[1], dt_met, dev))
            pair = astype_state(met=pair, dtype=f32)
            met_src = p_sim.FixedMet(pair)
            del pair
        else:
            met_src = None       # Simulation's own MetBuffer over METBASE
        lon, lat, p = inputs.draw_parcels(n, seed, cfg["parcels"], dev)
        atm = Atm(time=torch.zeros(n, dtype=torch.float64, device=dev), p=p,
                  lon=lon, lat=lat,
                  q={"t": torch.zeros(n, dtype=f32, device=dev),
                     "m": torch.ones(n, dtype=f32, device=dev)}, np=n)
        del lon, lat, p
        cache = Cache.zeros(n, dtype=f32, iso_npmax=1, device=dev)
        self.sim = p_sim.Simulation(ctl, atm, clim, met=met_src, cache=cache,
                                    dtype=f32)
        del atm, cache, met_src
        #: the program's control parameters
        self.ctl = self.sim.ctl
        # the climatology as read (float64, beside the Simulation's
        # float32 copy) stays allocated for the run, as it did when the
        # harness built the state: without it the file cell's peak falls
        # by its 10,240 B, and the peak is held equal to the earlier
        # runs' to the byte
        self._clim = clim
        self._orig_sort = p_sim.module_sort
        self._idx = None

    def swap_due(self, t: float) -> bool:
        """Whether the step at model time ``t`` swaps the met pair."""
        return bool(self.sim.met.swap_due(t))

    def step(self, t: float) -> None:
        """One step of the program at model time ``t`` (its sort and met
        swap when due), without output."""
        self.sim.advance(t, write_output=False)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def hook_sort(self, around: Callable[[], ContextManager],
                  hashes: Optional[list] = None) -> None:
        """Run each of the program's sorts inside ``around()``; where
        ``hashes`` is a list, append to it, for each sort, the order-free
        hash of every parcel before and after it and whether the count
        of parcels stayed."""
        orig = self._orig_sort

        def sort(met, atm, cache):
            h0 = checks.state_hash(atm, cache) if hashes is not None else None
            with around():
                out = orig(met, atm, cache)
            if hashes is not None:
                hashes.append((h0, checks.state_hash(*out),
                               atm.np == out[0].np))
            return out

        self._sim_module.module_sort = sort

    def unhook_sort(self) -> None:
        self._sim_module.module_sort = self._orig_sort

    def take(self, slots: np.ndarray) -> tuple:
        """(the state of parcel ``slots`` as ``checks.sample`` gives it,
        the random counter) now; the slots are the same in every call."""
        if self._idx is None:
            self._idx = torch.from_numpy(slots).to(self.device)
        return (checks.sample(self.sim.atm, self.sim.cache, self._idx),
                self.sim.cache.rng_ctr)

    def met_pair(self, names) -> tuple:
        """({name: numpy [2, ...]} of the program's met pair now, its two
        times)."""
        pair = self.sim.met.pair
        fields = {k: (pair.fields3d[k] if k in pair.fields3d
                      else pair.fields2d[k]).cpu().numpy() for k in names}
        return fields, tuple(float(x) for x in pair.time)

    def met_reads(self) -> list:
        """The program's record of its met reads so far (``MetBuffer``)."""
        return list(getattr(self.sim.met, "reads", []))

    def peak_bytes(self) -> List[int]:
        """The peak of allocated device memory on each card."""
        if self.device.type != "cuda":
            return [0]
        return [torch.cuda.max_memory_allocated(self.device)]

    def close(self) -> None:
        """Free the program's state."""
        self.unhook_sort()
        self.sim = self._idx = self._clim = None
        self.sync()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
