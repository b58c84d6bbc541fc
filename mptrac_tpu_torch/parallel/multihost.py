"""Multi-process runtime for the domain decomposition.

Counterpart of the JAX package's ``parallel/multihost.py``.  The
reference scales across nodes with MPI (dd_init c:2193, MPI_Alltoallv
c:2072-2193); JAX joins its multi-controller runtime; here every process
joins a ``torch.distributed`` process group (``init_distributed``) and
holds one subdomain on one device: NCCL carries CUDA tensors, gloo CPU
tensors.  The DD step (``parallel.dd.make_dd_step``) then exchanges
parcels with ``all_to_all_single`` across the processes.

Each process reads only its own subdomain's met hyperslab
(``dd.read_met_tile``) or receives rank 0's read (``read_met_shared``),
and holds only its own parcel block (``globalize`` records the global
shape beside it; nothing is gathered).
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Optional, Sequence

import torch

from mptrac_tpu_torch.parallel.mesh import Mesh, NamedSharding, Sharded
from mptrac_tpu_torch.types import Met, resolve_device

#: bytes of the header that read_met_shared broadcasts first
HEADER_BYTES = 65536


@dataclass(frozen=True)
class Runtime:
    """This process's place in the process group."""
    rank: int
    size: int
    device: torch.device
    backend: str


def init_distributed(coordinator: str, num_processes: int, process_id: int,
                     local_devices: Optional[Sequence] = None,
                     backend: Optional[str] = None) -> Runtime:
    """Join the process group (the reference dd_init's MPI_Init) at
    ``coordinator`` (``host:port``) as rank ``process_id`` of
    ``num_processes``.  ``local_devices`` names the rank's one device:
    by default CUDA device ``process_id`` modulo the devices present
    (``[torch.device("cpu")]`` for a rank on the CPU).  ``backend`` is
    NCCL for a CUDA device and gloo otherwise, unless given; a group
    that does not form raises."""
    import torch.distributed as dist

    if local_devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "init_distributed: no CUDA device; pass local_devices="
                "[torch.device('cpu')] for a rank on the CPU")
        local_devices = [torch.device(
            "cuda", process_id % torch.cuda.device_count())]
    if len(local_devices) != 1:
        raise NotImplementedError(
            "init_distributed: one device per process")
    dev = resolve_device(local_devices[0])
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend=backend,
                            init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)
    return Runtime(rank=dist.get_rank(), size=dist.get_world_size(),
                   device=dev, backend=dist.get_backend())


def global_mesh(runtime: Runtime, axis: str = "sub") -> Mesh:
    """One mesh over every process: this one holds position
    ``runtime.rank`` on ``runtime.device``."""
    return Mesh(devices=(runtime.device,), axis=axis,
                process_count=runtime.size, process_index=runtime.rank)


def globalize(mesh: Mesh, local_tree):
    """This process's blocks as ``Sharded`` leaves of the global arrays:
    each tensor of ``local_tree`` (a tensor, dict, list or dataclass of
    them) stays where it is, and its leading dimension is recorded as
    ``process_count`` times larger."""
    def one(x):
        if not isinstance(x, torch.Tensor):
            return x
        shape = (x.shape[0] * mesh.process_count,) + tuple(x.shape[1:])
        return Sharded((x,), NamedSharding(mesh, 0), shape)
    return _map(local_tree, one)


def localize(tree):
    """This process's blocks of ``Sharded`` leaves (or plain tensors) as
    host numpy arrays, its blocks concatenated along the split
    dimension."""
    def one(x):
        if isinstance(x, Sharded):
            return torch.cat([b.detach().cpu() for b in x.blocks],
                             dim=x.sharding.dim or 0).numpy()
        if isinstance(x, torch.Tensor):
            return x.detach().cpu().numpy()
        return x
    return _map(tree, one)


def _map(tree, fn):
    import dataclasses
    if isinstance(tree, (torch.Tensor, Sharded)):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return type(tree)(**{f.name: _map(getattr(tree, f.name), fn)
                             for f in dataclasses.fields(tree)})
    return tree


def _comm_device(runtime: Runtime) -> torch.device:
    """Where the collectives' tensors live: the rank's CUDA device under
    NCCL, the CPU under gloo."""
    return runtime.device if runtime.backend == "nccl" \
        else torch.device("cpu")


def read_met_shared(filename: str, ctl, runtime: Runtime, clim=None,
                    device=None) -> Met:
    """MET_MPI_SHARE (reference c:45-70, 7528-7540): rank 0 reads and
    preprocesses the met snapshot; every other rank receives the
    finished fields by broadcast instead of touching the file system.
    The header (shapes, dtypes, the static values) goes first as JSON,
    then one broadcast a field, so that the peak stays one field.  The
    result lies on ``device`` (the rank's by default)."""
    import torch.distributed as dist
    from mptrac_tpu_torch.met.build import read_met

    comm = _comm_device(runtime)
    dev = runtime.device if device is None else resolve_device(device)
    if runtime.rank == 0:
        met = read_met(filename, ctl, clim, device="cpu")
        leaves = _met_leaves(met)
        meta = dict(leaves=[(k, list(v.shape), str(v.dtype).split(".")[1])
                            for k, v in leaves],
                    time=met.time, coord_type=met.coord_type,
                    npl_ml=met.npl_ml, reg_lon=met.reg_lon,
                    reg_lat=met.reg_lat, lon_periodic=met.lon_periodic)
        text = json.dumps(meta).encode()
        if len(text) > HEADER_BYTES:
            raise ValueError("read_met_shared: header too long")
        head = torch.zeros(HEADER_BYTES, dtype=torch.uint8)
        head[:len(text)] = torch.frombuffer(bytearray(text),
                                            dtype=torch.uint8)
    else:
        leaves = None
        head = torch.zeros(HEADER_BYTES, dtype=torch.uint8)
    head = head.to(comm)
    dist.broadcast(head, src=0)
    meta = json.loads(bytes(head.cpu().numpy()).rstrip(b"\0").decode())
    got = {}
    for i, (key, shape, dtype) in enumerate(meta["leaves"]):
        if leaves is not None:
            buf = leaves[i][1].to(comm).contiguous()
        else:
            buf = torch.empty(shape, dtype=getattr(torch, dtype),
                              device=comm)
        dist.broadcast(buf, src=0)
        got[key] = buf.to(dev)
        del buf
    return Met(time=meta["time"], lon=got["lon"], lat=got["lat"],
               p=got["p"], hybrid=got["hybrid"],
               fields2d={k[3:]: v for k, v in got.items()
                         if k.startswith("2d:")},
               fields3d={k[3:]: v for k, v in got.items()
                         if k.startswith("3d:")},
               coord_type=meta["coord_type"], npl_ml=meta["npl_ml"],
               reg_lon=meta["reg_lon"], reg_lat=meta["reg_lat"],
               lon_periodic=meta["lon_periodic"])


def _met_leaves(met: Met):
    """(key, tensor) of every tensor of a snapshot, in a fixed order."""
    out = [(k, getattr(met, k)) for k in ("lon", "lat", "p", "hybrid")]
    out += [("2d:" + k, met.fields2d[k]) for k in sorted(met.fields2d)]
    out += [("3d:" + k, met.fields3d[k]) for k in sorted(met.fields3d)]
    return out


def allsum_scalar(x: float, runtime: Runtime) -> float:
    """The sum of a host number over the processes (diagnostic
    counters)."""
    import torch.distributed as dist
    t = torch.tensor([float(x)], dtype=torch.float64,
                     device=_comm_device(runtime))
    dist.all_reduce(t)
    return float(t.item())

