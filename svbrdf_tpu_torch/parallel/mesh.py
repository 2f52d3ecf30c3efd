"""The data group of data-parallel training: torch.distributed ranks, one
device each.

Counterpart of svbrdf_tpu/parallel/mesh.py. The JAX package trains on a 1-D
`data` mesh: the batch is sharded over the devices, the parameters are
replicated, and XLA inserts the gradient all-reduce. The port runs one
process per device, a rank of a torch.distributed group (NCCL between
cards, gloo on the CPU). Each rank holds a replica of the weights and the
optimizer state and takes its rows of every global batch; the data-parallel
step (parallel/step.DataParallelTrainStep) averages the gradients over the
group.

JAX's two modes are two ways to start the ranks:
  - one command, `--num-devices N` (main.py): N local ranks spawned from
    one process, the counterpart of one JAX process driving an N-device
    mesh. Every rank reads the whole corpus and keeps its rows of each
    global batch (process_count 1);
  - the launcher (parallel/multihost.py): one process per rank, the
    counterpart of JAX's process per host. Each reads its own file shard
    and feeds its rows (process_count = world).

Spatial sharding (--shard-spatial N, parallel/spatial) runs on the same
group: N local ranks split every image's height instead of the batch.

Host-side coordination (barriers, the validation sums, replica checksums)
rides a gloo group beside the data group, as JAX's sync_hosts rides the
coordination service and never the device. Every collective of either
group has the time limit the group was made with.

Not ported (TPU mechanisms): the mesh's shardings (batch_sharding,
replicated_sharding, stacked_batch_sharding, :45-58) and the stacked
K-step batches of the lax.scan programs.
"""

from __future__ import annotations

import hashlib
import socket
import time
from dataclasses import dataclass
from datetime import timedelta
from typing import Any, Iterable, List, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

# The time limit of every collective (JAX's sync_hosts default, 20 min),
# and of the barrier before exit, where the main process may still be
# writing test-mode grids (JAX's pre-exit barrier, 1 h).
COLLECTIVE_TIMEOUT = timedelta(minutes=20)
PRE_EXIT_TIMEOUT = timedelta(hours=1)


@dataclass(frozen=True)
class DataGroup:
    """This process's place in the data group.

    world ranks, this one `rank` on `device` (`local_rank` is its card's
    index, or the rank on the CPU), over `backend` ('nccl' | 'gloo').
    process_count is JAX's process count: 1 for the ranks of one
    --num-devices launch, world under the launcher. host_group is the gloo
    group of the host-side collectives."""

    world: int
    rank: int
    local_rank: int
    device: torch.device
    backend: str
    process_count: int
    host_group: Any
    timeout: timedelta

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    @property
    def process_index(self) -> int:
        """JAX's process index: the rank under the launcher, else 0."""
        return self.rank if self.process_count > 1 else 0

    def rows(self, batch: int) -> slice:
        """This rank's rows of a global batch of `batch` items."""
        if batch % self.world:
            raise ValueError(f"global batch size {batch} must be divisible "
                             f"by the world size {self.world}")
        n = batch // self.world
        return slice(self.rank * n, (self.rank + 1) * n)


def make_mesh(n_devices: int, device_type: str = "cuda",
              available: Optional[int] = None) -> List[torch.device]:
    """The devices of an n-rank data group, rank r on the r-th: cuda:0 ..
    cuda:n-1, or the CPU n times (gloo ranks).

    A hard requirement: asking for more ranks than there are devices
    (`available`; for cards by default torch.cuda.device_count(), for the
    CPU unbounded) raises instead of truncating (a truncated group would
    make an "8-way" run secretly smaller)."""
    if n_devices < 1:
        raise ValueError(f"a data group needs at least 1 rank, got "
                         f"{n_devices}")
    if available is None and device_type == "cuda":
        available = torch.cuda.device_count()
    if available is not None and n_devices > available:
        raise ValueError(f"requested a {n_devices}-device group but only "
                         f"{available} {device_type} device(s) are "
                         f"available")
    if device_type == "cpu":
        return [torch.device("cpu")] * n_devices
    return [torch.device("cuda", r) for r in range(n_devices)]


def free_port() -> int:
    """A TCP port free on localhost now (for a rendezvous address)."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn(fn, world: int, args: tuple = (),
          timeout: Optional[float] = None) -> None:
    """Run fn(rank, *args) in `world` processes from a `spawn` context.
    Returns when every one has ended; raises when one fails (the others
    are terminated), or when they still run after `timeout` seconds (all
    are terminated)."""
    ctx = mp.start_processes(fn, args=args, nprocs=world, join=False,
                             start_method="spawn")
    deadline = None if timeout is None else time.monotonic() + timeout
    while not ctx.join(None if deadline is None
                       else max(0.0, deadline - time.monotonic())):
        if deadline is not None and time.monotonic() >= deadline:
            for p in ctx.processes:
                p.kill()
                p.join()
            raise TimeoutError(f"{world} ranks still running after "
                               f"{timeout} s; killed")


def init_group(world: int, rank: int, device, init_method: str,
               process_count: int = 1, backend: Optional[str] = None,
               timeout: timedelta = COLLECTIVE_TIMEOUT) -> DataGroup:
    """Join the data group as `rank` of `world` on `device`: the card is
    made current first, then the process group is initialized at
    `init_method` (e.g. tcp://localhost:<port>) with `timeout`, and a gloo
    group is made beside it for the host-side collectives.

    The backend is NCCL for a card and gloo for the CPU unless given: gloo
    with a card puts ranks on one card, where NCCL refuses two ranks (a
    check, never the CLI's choice). A failed initialization raises."""
    device = torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("NCCL needs a CUDA device")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank, timeout=timeout)
    host = (dist.group.WORLD if backend == "gloo"
            else dist.new_group(backend="gloo", timeout=timeout))
    local = device.index if device.type == "cuda" else rank
    return DataGroup(world, rank, local, device, backend, process_count,
                     host, timeout)


def destroy_group() -> None:
    """Leave the data group (every process group of this process)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def local_batch_size(global_batch_size: int,
                     process_count: int = 1) -> int:
    """This process's share of the global batch (each process feeds only
    its own devices)."""
    if global_batch_size % process_count:
        raise ValueError(
            f"global batch size {global_batch_size} must be divisible by "
            f"the process count {process_count}")
    return global_batch_size // process_count


def sync_hosts(group: Optional[DataGroup], tag: str,
               timeout: Optional[timedelta] = None) -> None:
    """Barrier of every rank on the host group within `timeout` (the
    group's by default); a no-op without a group or at world size 1. A rank
    that does not arrive makes it raise, naming the tag."""
    if group is None or group.world == 1:
        return
    try:
        dist.monitored_barrier(group=group.host_group,
                               timeout=timeout or group.timeout,
                               wait_all_ranks=True)
    except RuntimeError as exc:
        raise RuntimeError(f"barrier {tag!r}: {exc}") from exc


def shard_batch(batch: dict, group: DataGroup) -> dict:
    """This rank's rows of a global batch (arrays or tensors, leading batch
    axis)."""
    return {k: v[group.rows(len(v))] for k, v in batch.items()}


def replicate_tree(tensors: Iterable[torch.Tensor],
                   group: Optional[DataGroup]) -> None:
    """Overwrite each tensor with rank 0's, in place (a broadcast per
    tensor: those on the device over the data group, those on the host over
    the host group); a no-op at world size 1."""
    if group is None or group.world == 1:
        return
    for t in tensors:
        on_host = t.device.type == "cpu" and group.backend != "gloo"
        dist.broadcast(t.detach(), src=0,
                       group=group.host_group if on_host else None)


def fetch_local_tree(tree):
    """The identity: every rank already holds its replica on its device
    (JAX's fetch copies a replicated global array to the host)."""
    return tree


def all_reduce_sum(values, group: DataGroup) -> np.ndarray:
    """The elementwise sum over the ranks of a vector of floats, in float64
    on the host group."""
    t = torch.tensor(np.asarray(values, np.float64))
    dist.all_reduce(t, group=group.host_group)
    return t.numpy()


def replica_checksums(tensors: Iterable[torch.Tensor],
                      group: DataGroup) -> List[str]:
    """Every rank's SHA-256 of the bytes of `tensors` (in order), gathered
    on the host group: equal strings are bit-identical replicas."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().reshape(-1)
                 .view(torch.uint8).numpy().tobytes())
    out = [None] * group.world
    dist.all_gather_object(out, h.hexdigest(), group=group.host_group)
    return out
