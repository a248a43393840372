"""Data-parallel ranks (PyTorch port of `rnn_transducer_tpu/parallel/mesh.py`).

The JAX package builds a 1-D `Mesh` over a "data" axis, shards the batch
over it, replicates the params and lets XLA insert the gradient
all-reduce. The port runs one process a rank under torch.distributed and
keeps the names:

  * `make_mesh(n_data, devices)` joins the process group and returns a
    `Mesh`: this rank, the world size, this rank's device and the group.
  * `shard_batch(mesh, batch)` takes this rank's contiguous slice of every
    array's leading axis (JAX's `P("data")`); T and U stay padded as they
    came.
  * `replicate(mesh, tree)` puts every tensor leaf on the rank's device
    and broadcasts it from rank 0 (JAX's `P()`).
  * `spawn(fn, n_data, devices)` runs `fn(mesh, *args)` on every rank: this
    process is rank 0 and the others are started with torch.multiprocessing
    (the kernel library is built once before they start).
  * `launch(fn, n_data, device_type)` is the CLIs' `--data-parallel`: it
    joins a torchrun group where one is set up, else calls `spawn`.

`train/loop.make_train_step(mesh=...)` all-reduces the gradients of each
rank's shard. The backend follows from the devices: NCCL when every rank
has a card of its own; gloo when the ranks are on the CPU or share one
card. Only `all_reduce` and `broadcast` touch tensors, and gloo takes both
on CUDA tensors (through the host); anything object-shaped goes through
`all_gather_object` on the host. Entry points take the card unless the
caller names CPU devices; no rank falls back to the CPU.
"""

from __future__ import annotations

import dataclasses
import datetime
import importlib
import os
import socket
import sys
from typing import Any

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

# collectives wait at most this long for a rank (NCCL does not notice a
# rank that died; gloo does, when its sockets close)
TIMEOUT_S = 1800


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of the 1-D "data" mesh. `group` is None for a mesh
    of one rank, which runs no collective."""

    rank: int
    size: int
    device: torch.device
    backend: str | None
    group: Any = None


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", 0)
    return d


def mesh_devices(n_data: int | None = None, devices=None) -> list:
    """The device of each rank: `devices`, or every visible card; the
    first n_data of them (all when n_data is None)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device for the mesh: pass devices="
                               "['cpu'] * n to run the ranks on the CPU")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devices = [_device(d) for d in devices]
    n_data = len(devices) if n_data is None else n_data
    if n_data < 1 or n_data > len(devices):
        raise ValueError(f"--data-parallel {n_data} > available devices "
                         f"{len(devices)}")
    return devices[:n_data]


def backend_for(devices) -> str:
    """nccl when every rank has a card of its own, gloo when they are on
    the CPU or share a card."""
    kinds = {d.type for d in devices}
    if kinds == {"cuda"} and len(set(devices)) == len(devices):
        return "nccl"
    if kinds <= {"cpu", "cuda"} and len(kinds) == 1:
        return "gloo"
    raise ValueError(f"a mesh needs ranks all on the CPU or all on cards; "
                     f"got {devices}")


def make_mesh(n_data: int | None = None, devices=None, *, rank=None,
              init_method: str | None = None,
              timeout_s: float = TIMEOUT_S) -> Mesh:
    """This rank's Mesh over n_data ranks on `devices` (one device a rank;
    default every visible card).

    rank: this process's rank; default the initialised process group's,
    else the RANK variable of a torchrun environment, else 0.
    init_method: where the ranks meet when the group is not yet
    initialised (default "env://": MASTER_ADDR / MASTER_PORT). A mesh of
    one rank starts no group.
    """
    devices = mesh_devices(n_data, devices)
    n = len(devices)
    if dist.is_initialized():
        if dist.get_world_size() != n:
            raise ValueError(f"the process group has {dist.get_world_size()}"
                             f" ranks, the mesh {n}")
        rank = dist.get_rank()
    elif rank is None:
        rank = int(os.environ.get("RANK", 0))
    if not 0 <= rank < n:
        raise ValueError(f"rank {rank} outside a mesh of {n}")
    device = devices[rank]
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if n == 1:
        return Mesh(rank, 1, device, None)
    backend = backend_for(devices)
    if not dist.is_initialized():
        dist.init_process_group(
            backend, init_method=init_method or "env://", world_size=n,
            rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
    if rank == 0:
        where = ("one card each" if backend == "nccl" else
                 "the CPU" if device.type == "cpu" else "shared cards")
        print(f"mesh: {n} ranks, backend {backend} ({where}: "
              f"{', '.join(str(d) for d in devices)})", file=sys.stderr,
              flush=True)
    return Mesh(rank, n, device, backend, dist.group.WORLD)


def close(mesh: Mesh) -> None:
    """Leave the process group of a mesh of more than one rank."""
    if mesh.group is not None and dist.is_initialized():
        dist.destroy_process_group()


def shard_batch(mesh: Mesh, batch):
    """This rank's contiguous slice of the leading axis of every array
    (numpy or tensor) in `batch`, a tensor or a tuple / list of them, on
    the rank's device."""
    def shard(x):
        x = torch.as_tensor(x)
        n = x.shape[0]
        if n % mesh.size:
            raise ValueError(f"batch of {n} does not divide by "
                             f"{mesh.size} ranks")
        per = n // mesh.size
        return x[mesh.rank * per:(mesh.rank + 1) * per].to(mesh.device)

    if isinstance(batch, (tuple, list)):
        return type(batch)(shard(x) for x in batch)
    return shard(batch)


def replicate(mesh: Mesh, tree):
    """Every tensor leaf of `tree` (dicts, lists, tuples, QTensors) copied
    to the rank's device and broadcast from rank 0, bit for bit (as bytes,
    whatever its dtype); other leaves stay as they are. The caller's
    tensors are not written."""
    leaves, spec = pytree.tree_flatten(tree)
    for i, x in enumerate(leaves):
        if isinstance(x, torch.Tensor):
            x = x.detach().to(mesh.device).clone(
                memory_format=torch.contiguous_format)
            if mesh.group is not None and x.numel():
                dist.broadcast(x.reshape(-1).view(torch.uint8), 0,
                               group=mesh.group)
            leaves[i] = x
    return pytree.tree_unflatten(leaves, spec)


def all_gather_objects(mesh: Mesh, obj) -> list:
    """[obj of rank 0, obj of rank 1, ...] on every rank, through the
    host (picklable objects)."""
    if mesh.group is None:
        return [obj]
    out = [None] * mesh.size
    dist.all_gather_object(out, obj, group=mesh.group)
    return out


def free_port() -> int:
    """A free TCP port on localhost for the ranks to meet at."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _portable(fn):
    """fn, or (module, name) for a function of a package's __main__ run
    with `python -m`, which the spawned interpreter does not re-import."""
    if fn.__module__ == "__main__":
        spec = getattr(sys.modules["__main__"], "__spec__", None)
        if spec is not None and spec.name.endswith("__main__"):
            return (spec.name, fn.__qualname__)
    return fn


def _rank_main(i, fn, n_data, devices, init_method, timeout_s, args):
    if isinstance(fn, tuple):
        fn = getattr(importlib.import_module(fn[0]), fn[1])
    mesh = make_mesh(n_data, devices, rank=i + 1, init_method=init_method,
                     timeout_s=timeout_s)
    try:
        fn(mesh, *args)
    finally:
        close(mesh)


def spawn(fn, n_data: int, devices=None, args: tuple = (),
          init_method: str | None = None, timeout_s: float = TIMEOUT_S):
    """Run fn(mesh, *args) on n_data ranks and return rank 0's result.

    This process is rank 0; ranks 1.. are new interpreters (torch
    multiprocessing, "spawn"). They meet at `init_method` (default
    tcp://127.0.0.1 on a free port; tests pass a file:// path of their
    own). A rank that raises makes spawn raise; on rank 0's failure the
    other ranks are terminated. With cards among the devices, the kernel
    library is built here first, so that the ranks load one build.
    """
    import torch.multiprocessing as tmp

    devices = mesh_devices(n_data, devices)
    if n_data == 1:
        mesh = make_mesh(1, devices)
        return fn(mesh, *args)
    if any(d.type == "cuda" for d in devices):
        from rnn_transducer_tpu_torch.utils import build
        build.load_library()
    init_method = init_method or f"tcp://127.0.0.1:{free_port()}"
    ctx = tmp.start_processes(
        _rank_main, args=(_portable(fn), n_data, [str(d) for d in devices],
                          init_method, timeout_s, args),
        nprocs=n_data - 1, join=False, start_method="spawn")
    try:
        mesh = make_mesh(n_data, devices, rank=0, init_method=init_method,
                         timeout_s=timeout_s)
        try:
            out = fn(mesh, *args)
        finally:
            close(mesh)
    except BaseException:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
        raise
    while not ctx.join():
        pass
    return out


def launch(fn, n_data: int, device_type: str, args: tuple = ()):
    """The CLIs' ranks: fn(mesh, *args) on n_data ranks, one card each
    (cuda:0 .. cuda:n_data-1) on "cuda", all on the CPU on "cpu". Under
    torchrun (RANK and WORLD_SIZE set) this process joins its group as
    its rank and returns its own result; otherwise `spawn` starts the
    ranks and returns rank 0's. More ranks than visible cards are
    refused."""
    if device_type == "cuda":
        try:
            devices = mesh_devices(n_data)
        except ValueError as e:
            raise SystemExit(str(e)) from None
    else:
        devices = ["cpu"] * n_data
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        mesh = make_mesh(n_data, devices, init_method="env://")
        try:
            return fn(mesh, *args)
        finally:
            close(mesh)
    return spawn(fn, n_data, devices, args=args)
