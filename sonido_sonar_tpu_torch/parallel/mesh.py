"""Mesh and sharding helpers (counterpart of `sonido_sonar_tpu/parallel/mesh.py`).

JAX shards one global array over a single-controller device mesh. A
torch tensor lives on one device, so the port's mesh is a table of
entries, each a `torch.device`, and a sharded batch is the list of this
process's row blocks, each on its entry's device:

- `Mesh`: the entries as a numpy object array shaped by the mesh, with
  JAX's `axis_names`, `shape` (an ordered axis -> size mapping), `size`
  and `local_devices`. Entries may repeat a device: a repeated entry is a
  shard that runs after the others on the same device. That is how an
  8-entry mesh is built from `torch.device("cpu")` (the CPU tests) and a
  2-entry mesh from one card (`make_mesh(devices=[cuda0, cuda0])`).
- Under a `torch.distributed` process group the mesh is global and
  rank-major, as JAX orders its global devices: each rank contributes its
  local devices, and its entries are its own (`Mesh.local`).
- `shard_over_batch(fn, mesh)` runs `fn` on each local shard's rows, on
  that shard's device, with no host synchronization between the shards,
  and concatenates the outputs on the first local entry's device (a
  stated difference from JAX, whose result is one global array). Under a
  process group the rows stay local, as JAX's addressable shards do.

Importing this module initializes neither CUDA nor a process group.
"""

from __future__ import annotations

import contextlib
from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist


class Mesh:
    """A device mesh: `devices` (a numpy object array of `torch.device`,
    shaped by the mesh) under `axis_names`; `process_ids` holds the rank
    that owns each entry, `local` the flat indices of this process's
    entries, and `distributed` whether the mesh was built across the
    ranks of a process group (whose results are then all-gathered).
    Entries may repeat a device (module docstring)."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str],
                 process_ids: Optional[np.ndarray] = None, process_index: int = 0,
                 distributed: bool = False):
        if devices.ndim != len(axis_names):
            raise ValueError(f"a {devices.ndim}-D device array for axes {tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.process_ids = (np.zeros(devices.shape, dtype=np.int64) if process_ids is None
                            else np.asarray(process_ids).reshape(devices.shape))
        self.process_index = process_index
        self.distributed = distributed
        self.local = tuple(int(i) for i in np.flatnonzero(self.process_ids.ravel() == process_index))

    @property
    def shape(self) -> "OrderedDict[str, int]":
        return OrderedDict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def local_devices(self) -> List[torch.device]:
        return [self.devices.flat[i] for i in self.local]

    def __repr__(self) -> str:
        return f"Mesh({dict(self.shape)}, {[str(d) for d in self.devices.flat]})"


@dataclass(frozen=True)
class NamedSharding:
    """A mesh and a partition spec (a tuple of axis names or None per
    array axis), the port's stand-in for `jax.sharding.NamedSharding`."""

    mesh: Mesh
    spec: Tuple[Optional[str], ...]


def _device_array(devices: Sequence[torch.device]) -> np.ndarray:
    arr = np.empty(len(devices), dtype=object)
    arr[:] = list(devices)
    return arr


def make_mesh(
    axis_names: Sequence[str] = ("data",),
    shape: Optional[Sequence[int]] = None,
    devices=None,
) -> Mesh:
    """Create a mesh over every visible CUDA device (or the given ones).

    Default: a 1-D mesh over the CUDA devices; with none visible and no
    `devices` it raises (it never falls back to the CPU). shape=(d, m)
    with axis_names=("data", "model") builds a 2-D mesh. Under a process
    group every rank calls it: the mesh is global, rank-major, each rank
    contributing its `devices` (its visible CUDA devices by default).
    """
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device is visible; pass devices=[...] "
                               "(for example [torch.device('cpu')] * 8) to build a mesh without one")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    local = [torch.device(d) for d in devices]
    if not local:
        raise ValueError("make_mesh: no devices")
    rank = 0
    everyone, owners = local, [0] * len(local)
    if dist.is_initialized():
        rank = dist.get_rank()
        per_rank = [None] * dist.get_world_size()
        dist.all_gather_object(per_rank, [str(d) for d in local])
        everyone = [torch.device(d) for names in per_rank for d in names]
        owners = [r for r, names in enumerate(per_rank) for _ in names]
    if shape is None:
        shape = (len(everyone),) if len(axis_names) == 1 else None
    if shape is None:
        raise ValueError("shape required for multi-axis meshes")
    return Mesh(_device_array(everyone).reshape(tuple(shape)), tuple(axis_names),
                np.asarray(owners).reshape(tuple(shape)), rank, dist.is_initialized())


def data_sharding(mesh: Mesh, axis: str = "data") -> NamedSharding:
    """Shard the leading (batch) axis."""
    return NamedSharding(mesh, (axis,))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


def on_device(device: torch.device):
    """A context in which `device` is CUDA's current device (a no-op for
    the CPU): its allocations, streams and events are that device's."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def _to(x, device: torch.device) -> torch.Tensor:
    """`x` on `device`: a tensor copied there (without a host wait when
    the copy goes to a card), numpy uploaded."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device, non_blocking=device.type == "cuda")


def _axis_coords(mesh: Mesh, axis: str) -> np.ndarray:
    """Each entry's index along `axis`, in flat order."""
    if axis not in mesh.axis_names:
        raise ValueError(f"axis {axis!r} is not one of the mesh's {mesh.axis_names}")
    return np.unravel_index(np.arange(mesh.size), mesh.devices.shape)[mesh.axis_names.index(axis)]


def local_shards(mesh: Mesh, axis: str = "data") -> List[Tuple[int, torch.device]]:
    """(shard index along `axis`, device) for each shard this process
    holds, in shard order. Entries along the other axes hold the same
    rows (replicas); a shard runs once, on its first local entry."""
    coords = _axis_coords(mesh, axis)
    first = {}
    for i in mesh.local:
        first.setdefault(int(coords[i]), mesh.devices.flat[i])
    return sorted(first.items())


def row_shards(n_rows: int, mesh: Mesh, axis: str = "data") -> List[Tuple[torch.device, int, int]]:
    """(device, first row, end row) of this process's shards of n_rows
    global rows split over `axis` as JAX splits them after padding to a
    multiple of the axis size: ceil(n_rows / size) rows a shard, the
    padding never placed. Empty shards are left out; a process left with
    none keeps one empty shard on its first local entry."""
    per = -(-n_rows // mesh.shape[axis])
    out = []
    for s, dev in local_shards(mesh, axis):
        lo, hi = s * per, min((s + 1) * per, n_rows)
        if lo < hi:
            out.append((dev, lo, hi))
    return out or [(mesh.local_devices[0], 0, 0)]


def gather_processes(obj, mesh: Mesh) -> list:
    """[obj] for a mesh of this process alone; for a mesh built across
    the ranks of a process group, every rank's obj, in rank order (a
    collective: every rank calls it)."""
    if not mesh.distributed:
        return [obj]
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def shard_batch(x, mesh: Mesh, axis: str = "data") -> List[torch.Tensor]:
    """Place a global [B, ...] array with B sharded over the mesh axis:
    the rows of each of this process's entries, on its device, in the
    order of `mesh.local`. B must be a multiple of the axis size (pad
    upstream with a validity mask); otherwise ValueError, as JAX's
    `device_put` raises."""
    coords = _axis_coords(mesh, axis)
    size = mesh.shape[axis]
    b = x.shape[0]
    if b % size:
        raise ValueError(f"shard_batch: {b} rows do not divide over the {size} entries of "
                         f"axis {axis!r}; pad to a multiple (pad_to_multiple)")
    per = b // size
    return [_to(x[int(coords[i]) * per:(int(coords[i]) + 1) * per], mesh.devices.flat[i])
            for i in mesh.local]


def pad_to_multiple(x: np.ndarray, multiple: int, axis: int = 0):
    """Pad axis 0 to a device-count multiple; returns (padded, n_valid)."""
    n = x.shape[axis]
    rem = (-n) % multiple
    if rem == 0:
        return x, n
    pad = [(0, 0)] * x.ndim
    pad[axis] = (0, rem)
    return np.pad(x, pad), n


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    device: str = "cuda",
) -> None:
    """Join a multi-process run: `torch.distributed.init_process_group`
    over tcp://coordinator_address (host:port of rank 0), NCCL for
    device="cuda" and gloo only when the caller asks for "cpu".

    A no-op when the group is already initialized, and when called in a
    single process without a coordinator and a process count. Every other
    failure raises (a missing rank, an unknown device, no CUDA device for
    NCCL, the rendezvous itself) instead of degrading to one process.
    Exercised by tests/test_torch_multihost.py with two processes over
    gloo."""
    if dist.is_initialized():
        return
    if coordinator_address is None and num_processes is None:
        return
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("initialize_distributed needs coordinator_address, num_processes "
                         f"and process_id (got {coordinator_address!r}, {num_processes!r}, "
                         f"{process_id!r})")
    backends = {"cuda": "nccl", "cpu": "gloo"}
    if device not in backends:
        raise ValueError(f"initialize_distributed: device {device!r}, expected 'cuda' or 'cpu'")
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("initialize_distributed: NCCL needs a CUDA device and none is "
                           "visible; pass device='cpu' for gloo")
    dist.init_process_group(backends[device], init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)


def _concat(outs: list, device: torch.device):
    """The shards' outputs (tensor, tuple or dict of tensors) joined along
    the batch axis on `device`."""
    first = outs[0]
    if isinstance(first, dict):
        return {k: _concat([o[k] for o in outs], device) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(_concat([o[i] for o in outs], device) for i in range(len(first)))
    return torch.cat([_to(o, device) for o in outs])


def shard_over_batch(fn: Callable, mesh: Mesh, axis: str = "data") -> Callable:
    """Wrap a batch-parallel function (no cross-batch dependencies) so
    each of this process's shards runs it on its rows, on its device.

    `fn` takes positional arrays whose leading axis is the batch and
    returns a tensor, tuple or dict of tensors with leading batch axes.
    The wrapped function takes this process's rows (in one process, the
    whole batch; under a process group, its own, as JAX's
    `make_array_from_process_local_data` does), which must divide evenly
    over the local shards (ValueError otherwise), and returns the outputs
    in row order on the first local entry's device. It puts no host
    synchronization between the shards: each shard's work is enqueued on
    its device's current stream in turn; any wait is fn's own.
    """
    shards = local_shards(mesh, axis)

    def wrapped(*args):
        b = args[0].shape[0]
        if b % len(shards):
            raise ValueError(f"{b} rows do not divide over this process's {len(shards)} "
                             f"shards of axis {axis!r}")
        per = b // len(shards)
        outs = []
        for j, (_, dev) in enumerate(shards):
            with on_device(dev):
                outs.append(fn(*(_to(a[j * per:(j + 1) * per], dev) for a in args)))
        return _concat(outs, shards[0][1])

    return wrapped
