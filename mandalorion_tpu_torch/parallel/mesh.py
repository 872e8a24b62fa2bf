"""The shard mesh and the pipeline-mesh context, on torch.distributed.

Counterpart of mandalorion_tpu/parallel/mesh.py. The batched device
dispatches of the pipeline (chain DP, affine-gap DP, POA chunk, the quant
count) consult `pipeline_mesh()`; with a mesh installed by `use_mesh`
each one splits its batch axis into `mesh.size` contiguous blocks, runs
this process's blocks on their devices, and gathers the results in shard
order (`fetch_global`), byte-identical to the meshless dispatch.

A mesh's global shards are ordered process-major: rank r holds shards
r * k .. r * k + k - 1, k = len(mesh.devices), the order of
`jax.devices()` across processes. Across processes the gathers and the
count's sum are collectives of the mesh's process group (NCCL on CUDA,
gloo on the CPU); in one process without a group they are a
concatenation and a sum, and no collective runs.
"""

from __future__ import annotations

import contextlib
import datetime
import math
import os
import time
from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from mandalorion_tpu_torch.runtime import resolve_device


class CollectiveStats:
    """Collectives this process issued and the host seconds they took,
    from after the card has finished the work before them to their
    result on the host; the mesh phase of chip_smoke.py reads them."""

    def __init__(self):
        self.count = 0
        self.seconds = 0.0

    @contextlib.contextmanager
    def timed(self):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.count += 1
            self.seconds += time.perf_counter() - t0


COLLECTIVES = CollectiveStats()


@dataclass(frozen=True)
class Mesh:
    """`devices`: this process's shard devices, in shard order; `group`:
    the process group the shards span (None: this process alone);
    `rank`/`world`: this process in that group; `shape`: the reads/loci
    factorisation of the global shard count over `axis_names`. Every
    dispatch shards over all axes."""

    devices: Tuple[torch.device, ...]
    group: Optional[object]
    rank: int
    world: int
    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]

    @property
    def size(self) -> int:
        """Global shard count: world x len(devices)."""
        return self.world * len(self.devices)

    @classmethod
    def from_devices(cls, devices: Sequence, group=None) -> "Mesh":
        """A one-axis ('reads') mesh over the given local devices,
        repeats allowed (two shards on one card). For tests and
        chip_smoke.py only: the command line builds its meshes with
        `make_mesh`."""
        devs = tuple(resolve_device(d) for d in devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        rank, world = _group_place(group)
        return cls(devs, group, rank, world, ("reads",),
                   (world * len(devs),))

    def shard_slices(self, b: int, pad_multiple: int = 1
                     ) -> Tuple[int, List[Tuple[torch.device, int, int]]]:
        """Pad a batch of b rows to a multiple of lcm(size, pad_multiple),
        at least one row a shard, and cut it into size contiguous blocks.
        Returns (padded batch, [(device, lo, hi)] for this process's
        shards); rows lo..hi at and past b are padding."""
        step = math.lcm(self.size, max(pad_multiple, 1))
        padded = max(-(-b // step) * step, step)
        per = padded // self.size
        first = self.rank * len(self.devices)
        return padded, [(dev, (first + i) * per, (first + i + 1) * per)
                        for i, dev in enumerate(self.devices)]

    def distinct_devices(self) -> List[torch.device]:
        return list(dict.fromkeys(self.devices))

    def comm_device(self) -> torch.device:
        """Where this process's gathers run: the first shard's card under
        NCCL, the CPU under gloo or without a group."""
        if self.group is not None and dist.get_backend(self.group) == "nccl":
            return self.devices[0]
        return torch.device("cpu")


def _group_place(group) -> Tuple[int, int]:
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


_PIPELINE_MESH: Optional[Mesh] = None


def pipeline_mesh() -> Optional[Mesh]:
    """The mesh installed by use_mesh (None = meshless execution)."""
    return _PIPELINE_MESH


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh]) -> Iterator[Optional[Mesh]]:
    """Install `mesh` as the pipeline mesh for the duration of the block;
    every batched device dispatch inside shards over it."""
    global _PIPELINE_MESH
    prev = _PIPELINE_MESH
    _PIPELINE_MESH = mesh
    try:
        yield mesh
    finally:
        _PIPELINE_MESH = prev


def mesh_shape(n: int, axis_names: Tuple[str, ...]
               ) -> Tuple[Tuple[str, ...], Tuple[int, ...]]:
    """The reference's factorisation: with two axes, loci is the largest
    power of two <= sqrt(n) that divides n and reads = n // loci; one
    axis when n == 1, loci == 1 or only one name is given."""
    if len(axis_names) == 1 or n == 1:
        return tuple(axis_names[:1]), (n,)
    loci = 1
    while loci * 2 <= int(np.sqrt(n)) and n % (loci * 2) == 0:
        loci *= 2
    if loci == 1:
        return tuple(axis_names[:1]), (n,)
    return tuple(axis_names[:2]), (n // loci, loci)


def make_mesh(n: Optional[int] = None,
              axis_names: Tuple[str, ...] = ("reads", "loci"),
              device="cuda") -> Mesh:
    """A mesh of n global shards on `device` ('cuda' or 'cpu').

    Without an initialised process group: on CUDA the first n distinct
    cards (fewer visible raises ValueError; two shards never share a card
    here), on the CPU n virtual shards. With one (torch.distributed's
    default group, W ranks): n % W == 0 and each rank takes n / W local
    shards; on CUDA rank cards c * n / W .. (c + 1) * n / W - 1, c being
    the rank's current card (`multihost_init` sets it)."""
    kind = torch.device(device).type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}: use cuda or cpu")
    group = dist.group.WORLD if dist.is_initialized() else None
    rank, world = _group_place(group)
    if kind == "cuda":
        resolve_device("cuda")
        visible = torch.cuda.device_count()
    if n is None:
        n = world * (visible if kind == "cuda" else 1)
    if n < 1 or n % world:
        raise ValueError(f"a {n}-shard mesh over {world} process(es): the "
                         f"shard count must be a positive multiple of the "
                         f"process count")
    local = n // world
    if kind == "cpu":
        devices = (torch.device("cpu"),) * local
    else:
        first = torch.cuda.current_device() * local if group is not None \
            else 0
        if first + local > visible:
            raise ValueError(
                f"requested a {n}-shard mesh ({local} card(s) from cuda:"
                f"{first} in this process) but only {visible} CUDA "
                f"device(s) are visible; two shards on one card only "
                f"through Mesh.from_devices")
        devices = tuple(torch.device("cuda", first + i)
                        for i in range(local))
    names, shape = mesh_shape(n, axis_names)
    return Mesh(devices, group, rank, world, names, shape)


def shard_batch(mesh: Mesh, arrays: Sequence[np.ndarray],
                pad_multiple: int = 1
                ) -> Tuple[List[List[torch.Tensor]], int]:
    """Pad each array's batch dim with zero rows to `shard_slices`'s
    padded size and cut it into contiguous blocks. Returns this process's
    shards ([shard][array] tensors on the shard's device) and the true
    batch size."""
    b = arrays[0].shape[0]
    _padded, slices = mesh.shard_slices(b, pad_multiple)
    return [[torch.from_numpy(pad_rows(a, lo, hi)).to(dev)
             for a in arrays] for dev, lo, hi in slices], b


def pad_rows(a: np.ndarray, lo: int, hi: int) -> np.ndarray:
    """Rows lo..hi of `a`, zero rows past its end; contiguous."""
    out = np.zeros((hi - lo,) + a.shape[1:], a.dtype)
    real = a[lo:min(hi, a.shape[0])]
    out[:len(real)] = real
    return out


def _np_dtype(dtype: torch.dtype) -> np.dtype:
    return torch.empty(0, dtype=dtype).numpy().dtype


def fetch_global(mesh: Mesh, shards: Sequence[Sequence[torch.Tensor]]
                 ) -> Tuple[np.ndarray, ...]:
    """Every global shard's results on this process, as numpy.

    shards: one tuple of tensors a local shard, the same shapes and types
    in every shard of every rank. Returns one array a tuple position: the
    shards' tensors concatenated along dim 0 in global shard order. With
    a group the local shards travel as one row of bytes each, in one
    all_gather (NCCL: all_gather_into_tensor on the first shard's card;
    gloo: on the CPU); without one they are concatenated here."""
    if len(shards) != len(mesh.devices):
        raise ValueError(f"{len(shards)} shards for {len(mesh.devices)} "
                         f"local devices")
    layout = [(t.dtype, tuple(t.shape)) for t in shards[0]]
    for part in shards:
        if [(t.dtype, tuple(t.shape)) for t in part] != layout:
            raise ValueError("shards differ in shape or type")
    where = mesh.comm_device()
    rows = torch.stack([torch.cat([
        t.detach().contiguous().reshape(-1).view(torch.uint8).to(where)
        for t in part]) for part in shards])
    if mesh.group is not None:
        out = torch.empty((mesh.size, rows.shape[1]), dtype=torch.uint8,
                          device=where)
        if where.type == "cuda":
            # the shards' kernels finish outside the collective's time
            torch.cuda.synchronize(where)
        with COLLECTIVES.timed():
            if where.type == "cuda":
                dist.all_gather_into_tensor(out, rows, group=mesh.group)
            else:
                dist.all_gather(list(out.view(mesh.world, *rows.shape)),
                                rows, group=mesh.group)
            host = out.cpu().numpy()
    else:
        host = rows.cpu().numpy()
    result, off = [], 0
    for dtype, shape in layout:
        dt = _np_dtype(dtype)
        nbytes = int(np.prod(shape, dtype=np.int64)) * dt.itemsize
        part = np.ascontiguousarray(host[:, off:off + nbytes])
        result.append(part.view(dt).reshape((mesh.size * shape[0],)
                                            + shape[1:]))
        off += nbytes
    return tuple(result)


def all_reduce_sum(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """x summed over the mesh's processes (x on mesh.comm_device()); x
    itself without a group."""
    if mesh.group is not None:
        if x.device.type == "cuda":
            torch.cuda.synchronize(x.device)
        with COLLECTIVES.timed():
            dist.all_reduce(x, op=dist.ReduceOp.SUM, group=mesh.group)
            if x.device.type == "cuda":
                torch.cuda.synchronize(x.device)
    return x


def all_reduce_max(mesh: Mesh, value: int) -> int:
    """An integer's maximum over the mesh's processes."""
    if mesh.group is None:
        return value
    x = torch.tensor([value], dtype=torch.int64, device=mesh.comm_device())
    with COLLECTIVES.timed():
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=mesh.group)
        value = int(x.item())
    return value


def multihost_init(coordinator: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None,
                   timeout_s: int = 300, device="cuda") -> None:
    """torch.distributed bootstrap: the default process group over
    num_processes ranks, NCCL for CUDA (the rank's current card set to
    process_id modulo the visible cards first) and gloo for the CPU,
    rendezvous at tcp://<coordinator> (host:port).

    Explicit arguments are a contract: a topology that cannot be formed
    raises RuntimeError naming it, and so does a process group that
    already exists. With no arguments the environment (MASTER_ADDR,
    MASTER_PORT, WORLD_SIZE, RANK) gives the topology, an existing group
    is kept, and without that environment nothing happens."""
    kind = torch.device(device).type
    backend = {"cuda": "nccl", "cpu": "gloo"}.get(kind)
    if backend is None:
        raise ValueError(f"unsupported device {device}: use cuda or cpu")
    explicit = (coordinator, num_processes, process_id) != (None,) * 3
    timeout = datetime.timedelta(seconds=timeout_s)
    if not explicit:
        if dist.is_initialized() or not all(
                k in os.environ for k in ("MASTER_ADDR", "WORLD_SIZE",
                                          "RANK")):
            return
        rank = int(os.environ["RANK"])
        kw = dict(init_method="env://")
        topology = (f"MASTER_ADDR={os.environ['MASTER_ADDR']} "
                    f"WORLD_SIZE={os.environ['WORLD_SIZE']} RANK={rank}")
    else:
        rank = process_id
        kw = dict(init_method=f"tcp://{coordinator}",
                  world_size=num_processes, rank=process_id)
        topology = (f"coordinator={coordinator} num_processes="
                    f"{num_processes} process_id={process_id}")
    try:
        if explicit and None in (coordinator, num_processes, process_id):
            raise ValueError("coordinator, num_processes and process_id "
                             "go together")
        if explicit and dist.is_initialized():
            raise RuntimeError("a process group is already initialised")
        if kind == "cuda":
            resolve_device("cuda")
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(backend, timeout=timeout, **kw)
    except (RuntimeError, ValueError) as e:
        raise RuntimeError(f"torch.distributed init ({backend}) failed for "
                           f"{topology}: {e}") from e
