"""Data-parallel ranks and the 2-D (data, model) mesh (PyTorch port of
`rnn_transducer_tpu/parallel/mesh.py` and of parallel/tp.py's
`make_mesh_2d` / `shard_batch_2d`).

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
  * `make_mesh_2d(n_data, n_model, devices)` is the model-parallel mesh
    (`Mesh2D`): rank r sits at (r // n_model, r % n_model), as JAX's
    `reshape(n_data, n_model)` places devices, with a model group (the
    ranks of its data row) and a data group (those of its model column).
    `shard_batch_2d` gives a rank its data row's slice; the ranks of a
    model group see the same rows. `spawn` and `launch` build one with
    `n_model=`; on fewer cards than ranks the ranks share them.
  * `gather_cat` and `all_to_all` are the tensor collectives beyond
    `all_reduce` and `broadcast` that the model-parallel step needs.
    Under gloo a CUDA tensor goes through a host copy, since gloo takes
    only `all_reduce` and `broadcast` on CUDA tensors; under NCCL it
    stays on the card. `COLLECTIVE_STATS` counts their calls and host ms.

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
import time
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


def mesh_devices(n_data: int | None = None, devices=None,
                 share: bool = False) -> list:
    """The device of each rank: `devices`, or every visible card; the
    first n_data of them (all when n_data is None). share: with fewer
    visible cards than n_data ranks, rank r takes card r % cards."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device for the mesh: pass devices="
                               "['cpu'] * n to run the ranks on the CPU")
        n_cards = torch.cuda.device_count()
        devices = [f"cuda:{i % n_cards}" for i in
                   range(max(n_cards, n_data or 0) if share else n_cards)]
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


@dataclasses.dataclass(frozen=True)
class Mesh2D:
    """One rank's view of the (data, model) mesh: rank r at data_rank =
    r // n_model, model_rank = r % n_model. `group` spans every rank,
    `model_group` the n_model ranks of this data row, `data_group` the
    n_data ranks of this model column; a group of one rank is None."""

    rank: int
    size: int
    device: torch.device
    backend: str | None
    n_data: int
    n_model: int
    group: Any = None
    model_group: Any = None
    data_group: Any = None

    @property
    def data_rank(self) -> int:
        return self.rank // self.n_model

    @property
    def model_rank(self) -> int:
        return self.rank % self.n_model


def make_mesh_2d(n_data: int, n_model: int, devices=None, *, rank=None,
                 init_method: str | None = None,
                 timeout_s: float = TIMEOUT_S) -> Mesh2D:
    """This rank's Mesh2D over n_data * n_model ranks on `devices` (one a
    rank; default every visible card, shared round-robin when there are
    fewer). Joins the process group as `make_mesh` does, then makes every
    model group and every data group on every rank, in one order."""
    n = n_data * n_model
    devices = mesh_devices(n, devices, share=True)
    base = make_mesh(n, devices, rank=rank, init_method=init_method,
                     timeout_s=timeout_s)
    if n == 1:
        return Mesh2D(0, 1, base.device, None, 1, 1)
    model_groups = [dist.new_group([d * n_model + m for m in range(n_model)])
                    if n_model > 1 else None for d in range(n_data)]
    data_groups = [dist.new_group([d * n_model + m for d in range(n_data)])
                   if n_data > 1 else None for m in range(n_model)]
    r = base.rank
    return Mesh2D(r, n, base.device, base.backend, n_data, n_model,
                  base.group, model_groups[r // n_model],
                  data_groups[r % n_model])


def shard_batch_2d(mesh: Mesh2D, batch):
    """This rank's data row's contiguous slice of the leading axis of
    every array in `batch` (JAX's `P("data")`, replicated over "model"),
    on the rank's device."""
    return shard_batch(Mesh(mesh.data_rank, mesh.n_data, mesh.device,
                            mesh.backend), batch)


# calls and host ms of the collectives below, by name
COLLECTIVE_STATS: dict[str, dict[str, float]] = {}


def _staged(mesh, x: torch.Tensor) -> torch.Tensor:
    """x as the backend takes it: a host copy of a CUDA tensor under
    gloo, else x itself; contiguous."""
    x = x.detach().contiguous()
    if mesh.backend == "gloo" and x.device.type == "cuda":
        return x.cpu()
    return x


def _count(name: str, t0: float) -> None:
    st = COLLECTIVE_STATS.setdefault(name, {"calls": 0, "ms": 0.0})
    st["calls"] += 1
    st["ms"] += (time.perf_counter() - t0) * 1e3


def gather_cat(mesh, x: torch.Tensor, group, n: int,
               dim: int) -> torch.Tensor:
    """The n ranks' x of `group` concatenated along `dim` in group-rank
    order, on x's device (no gradient)."""
    if n == 1:
        return x.detach()
    t0 = time.perf_counter()
    src = _staged(mesh, x)
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim).to(x.device)
    _count("gather_cat", t0)
    return out


def all_to_all(mesh, x: torch.Tensor, group, n: int) -> torch.Tensor:
    """The all-to-all of x (n, ...) over `group`'s n ranks along dim 0:
    row s goes to group rank s, row s of the result came from group rank
    s (JAX's `all_to_all(split_axis=0, concat_axis=0)`); no gradient."""
    if n == 1:
        return x.detach()
    t0 = time.perf_counter()
    src = _staged(mesh, x)
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    out = out.to(x.device)
    _count("all_to_all", t0)
    return out


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """SUM of x over `group` (None: a group of one rank), in place."""
    if group is not None:
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


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


def _join(n_ranks, devices, rank, init_method, timeout_s, n_model):
    """make_mesh over n_ranks, or with n_model > 1 make_mesh_2d."""
    if n_model > 1:
        return make_mesh_2d(n_ranks // n_model, n_model, devices, rank=rank,
                            init_method=init_method, timeout_s=timeout_s)
    return make_mesh(n_ranks, devices, rank=rank, init_method=init_method,
                     timeout_s=timeout_s)


def _rank_main(i, fn, n_data, devices, init_method, timeout_s, args,
               n_model=1):
    if isinstance(fn, tuple):
        fn = getattr(importlib.import_module(fn[0]), fn[1])
    mesh = _join(n_data, devices, i + 1, init_method, timeout_s, n_model)
    try:
        fn(mesh, *args)
    finally:
        close(mesh)


def spawn(fn, n_data: int, devices=None, args: tuple = (),
          init_method: str | None = None, timeout_s: float = TIMEOUT_S,
          n_model: int = 1):
    """Run fn(mesh, *args) on n_data ranks and return rank 0's result.
    With n_model > 1 the n_data ranks form a Mesh2D of n_data // n_model
    data rows of n_model ranks (`make_mesh_2d`), sharing the cards when
    there are fewer.

    This process is rank 0; ranks 1.. are new interpreters (torch
    multiprocessing, "spawn"). They meet at `init_method` (default
    tcp://127.0.0.1 on a free port; tests pass a file:// path of their
    own). A rank that raises makes spawn raise; on rank 0's failure the
    other ranks are terminated. With cards among the devices, the kernel
    library is built here first, so that the ranks load one build.
    """
    import torch.multiprocessing as tmp

    devices = mesh_devices(n_data, devices, share=n_model > 1)
    if n_data == 1:
        mesh = _join(1, devices, None, None, timeout_s, n_model)
        return fn(mesh, *args)
    if any(d.type == "cuda" for d in devices):
        from rnn_transducer_tpu_torch.utils import build
        build.load_library()
    init_method = init_method or f"tcp://127.0.0.1:{free_port()}"
    ctx = tmp.start_processes(
        _rank_main, args=(_portable(fn), n_data, [str(d) for d in devices],
                          init_method, timeout_s, args, n_model),
        nprocs=n_data - 1, join=False, start_method="spawn")
    try:
        mesh = _join(n_data, devices, 0, init_method, timeout_s, n_model)
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


def launch(fn, n_data: int, device_type: str, args: tuple = (),
           n_model: int = 1):
    """The CLIs' ranks: fn(mesh, *args) on n_data ranks, one card each
    (cuda:0 .. cuda:n_data-1) on "cuda", all on the CPU on "cpu". Under
    torchrun (RANK and WORLD_SIZE set) this process joins its group as
    its rank and returns its own result; otherwise `spawn` starts the
    ranks and returns rank 0's. More ranks than visible cards are
    refused, except with n_model > 1 (`--model-parallel`: a Mesh2D of
    n_data // n_model rows), whose ranks share the cards there are."""
    if device_type == "cuda":
        try:
            devices = mesh_devices(n_data, share=n_model > 1)
        except ValueError as e:
            raise SystemExit(str(e)) from None
    else:
        devices = ["cpu"] * n_data
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        mesh = _join(n_data, devices, None, "env://", TIMEOUT_S, n_model)
        try:
            return fn(mesh, *args)
        finally:
            close(mesh)
    return spawn(fn, n_data, devices, args=args, n_model=n_model)
