"""A driver that runs one domain-decomposed ``Simulation`` of the program
on one card (or the CPU in the tests): the configuration's ``DD 1``
with every subdomain in one process on the card, as MPTRAC's dd_test
puts every rank on one machine.

The program under test is ``mptrac_tpu_torch``, driven through its own
entry points: ``config.read_ctl``, ``types.Atm`` / ``Cache``,
``sim.Simulation`` with ``sim.FixedMet`` (met in memory) or its default
``sim.MetBuffer``, and ``Simulation.advance`` step by step.  The
parcels are drawn as ``single`` draws them, with the quantity ``idx``
the parcel's global slot number; the decomposed state holds each
subdomain's live parcels in a block of its own (``Simulation.dd``), and
``take`` finds the sampled slots by ``idx``.  A program whose
``Simulation`` has no decomposed state is refused at once: it would run
the undecomposed step under this cell's name.

``hook_sort`` runs each of the program's sorts inside ``around()``;
with ``hashes``, around each sort and each migration (the decomposed
step's exchange, from the parcels its physics left in range of the
global grid to the blocks after it) it appends the order-free hash of
the blocks' live parcels before and after, and whether every parcel is
still counted (live + lost == n, none overflowed) and every sampled
parcel sits in the block of the subdomain that the reference's
``owner`` names.
"""

from __future__ import annotations

from typing import Callable, ContextManager, List, Optional

import numpy as np
import torch

from benchmark import checks, inputs, manifest
from benchmark.manifest import RunError


def _load_single():
    """``drivers/single.py`` (its met conversion is the same here)."""
    return manifest.driver({"driver": "single"})


class _Hashed:
    """The columns that ``checks.state_hash`` and ``checks.sample`` read,
    from a decomposed state's slots ``sl``: the index in the place of
    the mass (the sample exact in float64; the hash over its two words
    folded into one)."""

    def __init__(self, atm, cache, sl, for_hash: bool):
        self.time, self.lon, self.lat, self.p = (
            atm.time[sl], atm.lon[sl], atm.lat[sl], atm.p[sl])
        idx = atm.q["idx"][sl]
        if for_hash:
            w = idx.contiguous().view(torch.int32)
            idx = torch.bitwise_xor(w[0::2], w[1::2]).view(torch.float32)
        self.q = {"t": atm.q["t"][sl], "m": idx}
        self.uvwp = cache.uvwp[:, sl]


class Driver:
    """The program's decomposed state and ``Simulation`` of one cell on
    ``device``; the arguments are those of ``drivers/single.py``."""

    def __init__(self, cfg: dict, wl: dict, args: List[str],
                 snaps: Optional[list], seed: int, device: torch.device):
        if cfg["dtype"] != "float32":
            raise RunError(f"the driver dd runs float32, the configuration "
                           f"states {cfg['dtype']}")
        if wl["chips"] != 1:
            raise RunError(f"the driver dd runs on one card, the cell asks "
                           f"for {wl['chips']}")
        from mptrac_tpu_torch import config as p_config
        from mptrac_tpu_torch import sim as p_sim
        if not hasattr(p_sim, "DDRun"):
            raise RunError("the program's Simulation runs no domain "
                           "decomposition")
        from mptrac_tpu_torch.climatology import read_clim
        from mptrac_tpu_torch.physics import pipeline as p_pipeline
        from mptrac_tpu_torch.types import (Atm, Cache, astype_state,
                                            stack_met)
        from mptrac_tpu_torch.utils import log as p_log

        self.device = dev = device
        if dev.type == "cuda":
            torch.cuda.set_device(0)
            torch.cuda.reset_peak_memory_stats(dev)
            from mptrac_tpu_torch.ops import _cuda
            _cuda.load()             # builds the kernels on a first run
        self._pipeline = p_pipeline
        self.n = n = int(cfg["n_parcels"])
        self._seed, self._check_slots = seed, int(wl["check"]["slots"])
        p_log.set_level(0)
        ctl = p_config.read_ctl(None, args)
        if not ctl.dd:
            raise RunError("the driver dd runs DD 1, the configuration "
                           "does not set it")
        clim = read_clim(ctl, device=dev)
        f32 = torch.float32
        if snaps is not None:
            program_met = _load_single()._program_met
            dt_met = float(wl["met"]["dt_met"])
            pair = stack_met(program_met(snaps[0], 0.0, dev),
                             program_met(snaps[1], dt_met, dev))
            pair = astype_state(met=pair, dtype=f32)
            met_src = p_sim.FixedMet(pair)
            del pair
            lon_axis, lat_axis = snaps[0][0], snaps[0][1]
        else:
            met_src = None       # Simulation's own MetBuffer over METBASE
            lon_axis = lat_axis = None
        lon, lat, p = inputs.draw_parcels(n, seed, cfg["parcels"], dev)
        atm = Atm(time=torch.zeros(n, dtype=torch.float64, device=dev), p=p,
                  lon=lon, lat=lat,
                  q={"t": torch.zeros(n, dtype=f32, device=dev),
                     "idx": torch.arange(n, dtype=torch.float64,
                                         device=dev)}, np=n)
        del lon, lat, p
        cache = Cache.zeros(n, dtype=f32, iso_npmax=1, device=dev)
        self.sim = p_sim.Simulation(ctl, atm, clim, met=met_src, cache=cache,
                                    dtype=f32)
        del atm, cache, met_src
        if getattr(self.sim, "dd", None) is None:
            raise RunError("the program's Simulation holds no decomposed "
                           "state: it would run the undecomposed step")
        #: the program's control parameters
        self.ctl = self.sim.ctl
        self._clim = clim
        if lon_axis is None:
            pair = self.sim.met.pair
            lon_axis, lat_axis = (pair.lon[0].cpu().numpy(),
                                  pair.lat[0].cpu().numpy())
        self._axes = (np.asarray(lon_axis, np.float64),
                      np.asarray(lat_axis, np.float64))
        self._lat_range = (float(self._axes[1].min()),
                           float(self._axes[1].max()))
        self._ref = manifest.reference(cfg)
        self._patched: list = []
        self._want = self._sampled = None
        self._physics: Optional[list] = None

    # ------------------------------------------------------------ stepping

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

    # ------------------------------------------------------------- hooks

    def _patch(self, obj, attr: str, fn) -> None:
        self._patched.append((obj, attr, obj.__dict__.get(attr)))
        setattr(obj, attr, fn)

    def hook_sort(self, around: Callable[[], ContextManager],
                  hashes: Optional[list] = None) -> None:
        """Run each of the program's sorts inside ``around()``; where
        ``hashes`` is a list, append to it, for each sort and each
        migration, the order-free hash of the parcels before and after
        it, and whether the parcels are all counted and owned (see the
        module docstring)."""
        self.unhook_sort()
        sim = self.sim
        orig_sort = type(sim).sort.__get__(sim)

        def sort(met01=None):
            h0 = self._blocks_hash() if hashes is not None else None
            with around():
                orig_sort(met01)
            if hashes is not None:
                hashes.append((h0, self._blocks_hash(), self._held(
                    sim.atm, sim.dd_counts["lost"],
                    sim.dd_counts["overflow"])))

        self._patch(sim, "sort", sort)
        if hashes is None:
            return
        orig_step = sim.dd.step
        orig_physics = self._pipeline.run_timestep

        def step(tiles, atm, cache, t, flags=None):
            self._physics = []
            try:
                out = orig_step(tiles, atm, cache, t, flags)
            finally:
                physics, self._physics = self._physics, None
            a2, c2, overflow, lost = out
            hashes.append((
                sum(int(h) for h in physics), self._blocks_hash(a2, c2),
                self._held(a2, sim.dd_counts["lost"] + int(lost.sum()),
                           sim.dd_counts["overflow"]
                           + int(overflow.sum()))))
            return out

        def run_timestep(ctl, clim, met, atm, cache, *a, **kw):
            out = orig_physics(ctl, clim, met, atm, cache, *a, **kw)
            if self._physics is not None:
                a2, c2 = out
                lat = a2.lat[:a2.np].to(torch.float64)
                keep = torch.nonzero((lat >= self._lat_range[0])
                                     & (lat <= self._lat_range[1])
                                     ).flatten()
                self._physics.append(checks.state_hash(
                    *self._columns(a2, c2, keep, True)))
            return out

        self._patch(sim.dd, "step", step)
        self._patch(self._pipeline, "run_timestep", run_timestep)

    def unhook_sort(self) -> None:
        for obj, attr, orig in reversed(self._patched):
            if orig is None:             # an instance's method
                delattr(obj, attr)
            else:
                setattr(obj, attr, orig)
        self._patched.clear()
        self._physics = None

    @staticmethod
    def _columns(atm, cache, sl, for_hash: bool):
        h = _Hashed(atm, cache, sl, for_hash)
        return h, h

    def _blocks(self, atm):
        """The slots of each subdomain's live parcels."""
        cap = self.sim.dd.cap
        return [slice(i * cap, i * cap + int(k))
                for i, k in enumerate(atm.np)]

    def _blocks_hash(self, atm=None, cache=None) -> int:
        """The order-free hash summed over the blocks' live parcels."""
        atm = self.sim.atm if atm is None else atm
        cache = self.sim.cache if cache is None else cache
        return sum(int(checks.state_hash(*self._columns(atm, cache, sl,
                                                        True)))
                   for sl in self._blocks(atm))

    def _held(self, atm, lost: int, overflow: int) -> bool:
        """Whether every parcel is counted (live + lost == n, none
        overflowed) and every sampled parcel sits in its owner's block."""
        if int(np.sum(atm.np)) + lost != self.n or overflow:
            return False
        if self._sampled is None:
            self._sampled = inputs.draw_slots(self.n, self._check_slots,
                                              self._seed, 11)
        pos = self._find(atm, self._sampled)
        if pos is None:
            return False
        sel = torch.from_numpy(pos).to(atm.lon.device)
        lon = atm.lon[sel].to(torch.float64).cpu().numpy()
        lat = atm.lat[sel].to(torch.float64).cpu().numpy()
        near = self._ref.owners_near(lon, lat, *self._axes,
                                     self.ctl.dd_subdomains_zonal,
                                     self.ctl.dd_subdomains_meridional)
        block = pos // self.sim.dd.cap
        return bool(np.all(np.any(near == block[None], axis=0)))

    def _find(self, atm, slots: np.ndarray) -> Optional[np.ndarray]:
        """The decomposed state's slot of each parcel whose ``idx`` is one
        of ``slots`` (sorted), in that order; None where one is missing
        or held twice."""
        dev = atm.time.device
        if self._want is None or not np.array_equal(self._want[0], slots):
            want = torch.zeros(self.n, dtype=torch.bool, device=dev)
            want[torch.from_numpy(slots).to(dev)] = True
            self._want = (slots, want)
        want = self._want[1]
        found, where = [], []
        for sl in self._blocks(atm):
            idx = atm.q["idx"][sl]
            ok = (idx >= 0) & (idx < self.n) & (idx == torch.floor(idx))
            hit = torch.zeros_like(ok)
            hit[ok] = want[idx[ok].to(torch.int64)]
            k = torch.nonzero(hit).flatten()
            found.append(idx[k].to(torch.int64))
            where.append(k + sl.start)
        found = torch.cat(found).cpu().numpy()
        where = torch.cat(where).cpu().numpy()
        if found.size != slots.size:
            return None
        order = np.argsort(found, kind="stable")
        if not np.array_equal(found[order], slots):
            return None
        return where[order]

    # --------------------------------------------------------- the checks

    def take(self, slots: np.ndarray) -> tuple:
        """(the state of the parcels whose ``idx`` is one of ``slots``, as
        ``checks.sample`` gives it, the index in the place of the mass;
        NaN throughout where a parcel is missing or held twice, the
        random counters of the subdomains) now."""
        pos = self._find(self.sim.atm, slots)
        dev = self.sim.atm.time.device
        if pos is None:
            nan = torch.full((slots.size,), float("nan"), dtype=torch.float64)
            return ({k: nan.clone() for k in checks.STATE_KEYS},
                    self.sim.cache.rng_ctr)
        cols = self._columns(self.sim.atm, self.sim.cache, slice(None), False)
        return (checks.sample(*cols, torch.from_numpy(pos).to(dev)),
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
        self.sim = self._clim = self._want = None
        self.sync()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
