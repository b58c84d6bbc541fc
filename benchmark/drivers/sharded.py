"""A driver that runs one ``Simulation`` of the program over the cell's
cards: the parcels sharded over a mesh of ``chips`` cards
(``parallel.mesh``), the met pair and the climatology replicated, each
card stepping and sorting its own parcels, as MPTRAC's GPU runs put one
MPI rank on each GPU of a node (mptrac.c:6116).  In the CPU tests the
mesh names the CPU ``chips`` times.

The program under test is ``mptrac_tpu_torch``, driven through its own
entry points: ``parallel.mesh.make_mesh``, ``join_atm`` and
``join_cache`` (the state from each card's block), ``sim.Simulation``
with ``mesh=`` and ``sim.FixedMet`` (met in memory) or its default
``sim.MetBuffer``, and ``Simulation.advance`` step by step.

Each card's parcels are drawn on that card from the run's seed and the
card's index, so no card and not the host holds more than one card's
share.  The slots, the random draws and the counts are the global run's:
card k holds the slots k * n / chips to (k + 1) * n / chips - 1, and
``take`` gathers the sampled slots from the cards that hold them.  Each
card sorts its own parcels; ``hook_sort`` hashes around each card's sort
and sums the hashes over the cards, one entry a sort of the run.
"""

from __future__ import annotations

import inspect
import threading
from typing import Callable, ContextManager, List, Optional

import numpy as np
import torch

from benchmark import checks, inputs
from benchmark.manifest import RunError


def _load_single():
    """``drivers/single.py`` (its met conversion is the same here)."""
    from benchmark import manifest
    return manifest.driver({"driver": "single"})


def card_seed(seed: int, k: int) -> int:
    """The seed of card ``k``'s parcel draws (64 bits, from the run's
    seed and the card's index)."""
    ss = np.random.SeedSequence([int(seed) & (2 ** 63 - 1), 13, int(k)])
    return int(ss.generate_state(1, np.uint64)[0])


class Driver:
    """The program's sharded state and ``Simulation`` of one cell over
    ``wl["chips"]`` cards (``device`` ``cuda``: cuda:0 to cuda:chips-1;
    ``cpu``: the CPU named ``chips`` times); the arguments are those of
    ``drivers/single.py``."""

    def __init__(self, cfg: dict, wl: dict, args: List[str],
                 snaps: Optional[list], seed: int, device: torch.device):
        if cfg["dtype"] != "float32":
            raise RunError(f"the driver sharded runs float32, the "
                           f"configuration states {cfg['dtype']}")
        chips = int(wl["chips"])
        n = int(cfg["n_parcels"])
        if n % chips:
            raise RunError(f"{n} parcels do not split into {chips} equal "
                           f"shares")
        from mptrac_tpu_torch import config as p_config
        from mptrac_tpu_torch import sim as p_sim
        from mptrac_tpu_torch.climatology import read_clim
        from mptrac_tpu_torch.types import (Atm, Cache, astype_state,
                                            stack_met)
        from mptrac_tpu_torch.utils import log as p_log
        if "mesh" not in inspect.signature(p_sim.Simulation).parameters:
            raise RunError("the program's Simulation takes no mesh")
        from mptrac_tpu_torch.parallel import mesh as p_mesh

        if device.type == "cuda":
            devices = [torch.device("cuda", k) for k in range(chips)]
            torch.cuda.set_device(0)
            for d in devices:
                torch.cuda.reset_peak_memory_stats(d)
            from mptrac_tpu_torch.ops import _cuda
            _cuda.load()             # builds the kernels on a first run
        else:
            devices = [device] * chips
        self.devices = devices
        self.mesh = p_mesh.make_mesh(chips, devices=devices)
        self._mesh_module = p_mesh
        self._sim_module = p_sim
        dev0 = devices[0]
        p_log.set_level(0)
        ctl = p_config.read_ctl(None, args)
        clim = read_clim(ctl, device=dev0)
        f32 = torch.float32
        if snaps is not None:
            program_met = _load_single()._program_met
            dt_met = float(wl["met"]["dt_met"])
            pair = stack_met(program_met(snaps[0], 0.0, dev0),
                             program_met(snaps[1], dt_met, dev0))
            pair = astype_state(met=pair, dtype=f32)
            met_src = p_sim.FixedMet(pair)
            del pair
        else:
            met_src = None       # Simulation's own MetBuffer over METBASE
        npc = n // chips
        atms, caches = [], []
        for k, d in enumerate(devices):
            lon, lat, p = inputs.draw_parcels(npc, card_seed(seed, k),
                                              cfg["parcels"], d)
            atms.append(Atm(
                time=torch.zeros(npc, dtype=torch.float64, device=d), p=p,
                lon=lon, lat=lat,
                q={"t": torch.zeros(npc, dtype=f32, device=d),
                   "m": torch.ones(npc, dtype=f32, device=d)}, np=npc))
            caches.append(Cache.zeros(npc, dtype=f32, iso_npmax=1,
                                      device=d))
            del lon, lat, p
        atm = p_mesh.join_atm(atms, self.mesh, n)
        cache = p_mesh.join_cache(caches, self.mesh)
        del atms, caches
        self.sim = p_sim.Simulation(ctl, atm, clim, met=met_src, cache=cache,
                                    dtype=f32, mesh=self.mesh)
        del atm, cache, met_src
        #: the program's control parameters
        self.ctl = self.sim.ctl
        self._clim = clim
        self._orig_sort = p_sim.module_sort
        self._idx = None
        self._hashes: Optional[list] = None
        self._pending: list = []
        self._lock = threading.Lock()

    def swap_due(self, t: float) -> bool:
        """Whether the step at model time ``t`` swaps the met pair."""
        return bool(self.sim.met.swap_due(t))

    def step(self, t: float) -> None:
        """One step of the program at model time ``t`` on every card
        (each card's sort and the met swap when due), without output;
        the hashes of a sort's cards become one entry."""
        self.sim.advance(t, write_output=False)
        if self._pending:
            cards, self._pending = self._pending, []
            self._hashes.append((
                sum(int(h0) for h0, _, _ in cards),
                sum(int(h1) for _, h1, _ in cards),
                len(cards) == len(self.devices)
                and all(same for _, _, same in cards)))

    def sync(self) -> None:
        for d in dict.fromkeys(self.devices):
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    def hook_sort(self, around: Callable[[], ContextManager],
                  hashes: Optional[list] = None) -> None:
        """Run each card's sort inside ``around()``; where ``hashes`` is
        a list, append to it, for each sort of the run, the order-free
        hash of every parcel before and after it, each summed over the
        cards, and whether every card sorted and kept its count."""
        orig = self._orig_sort
        self._hashes = hashes

        def sort(met, atm, cache):         # on the card's own thread
            h0 = checks.state_hash(atm, cache) if hashes is not None else None
            with around():
                out = orig(met, atm, cache)
            if hashes is not None:
                rec = (h0, checks.state_hash(*out), atm.np == out[0].np)
                with self._lock:
                    self._pending.append(rec)
            return out

        self._sim_module.module_sort = sort

    def unhook_sort(self) -> None:
        self._sim_module.module_sort = self._orig_sort
        self._hashes = None

    def take(self, slots: np.ndarray) -> tuple:
        """(the state of the global parcel ``slots`` as ``checks.sample``
        gives it, gathered from the cards that hold them, the random
        counter) now; the slots are the same in every call."""
        m = self._mesh_module
        npc = self.sim.atm.time.blocks[0].shape[0]
        if self._idx is None:
            card = slots // npc
            self._idx = [
                (k, torch.from_numpy(slots[card == k] - k * npc).to(d))
                for k, d in enumerate(self.devices) if np.any(card == k)]
        parts = [checks.sample(m.atm_block(self.sim.atm, k),
                               m.cache_block(self.sim.cache, k), idx)
                 for k, idx in self._idx]
        state = {key: torch.cat([p[key] for p in parts])
                 for key in parts[0]}
        return state, self.sim.cache.rng_ctr

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
        return [torch.cuda.max_memory_allocated(d) if d.type == "cuda"
                else 0 for d in self.devices]

    def close(self) -> None:
        """Free the program's state and stop its shards' threads."""
        self.unhook_sort()
        if self.sim is not None:
            self.sim.close()
        self.sim = self._idx = self._clim = None
        self.sync()
        if self.devices[0].type == "cuda":
            torch.cuda.empty_cache()
