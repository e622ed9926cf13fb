"""Data parallelism over processes, the counterpart of
`centerpose_tpu/parallel/mesh.py`.

The JAX package builds a 1-D `data` mesh over the chips of one process,
replicates the train state, shards each batch on axis 0 and lets XLA insert
the gradient psum under `jit`; BatchNorm statistics are global reductions
there. Here every device is a process (a rank) of one `torch.distributed`
process group, the world (`World`, the mesh's counterpart):

  launch(fn, n)      spawn n ranks, each `fn(world, *args)`, and return their
                     results; `init_world` / `destroy_world` inside each rank
  shard_batch(w, b)  rank r's rows [r*B/n, (r+1)*B/n) of a global batch
  replicate(w, m)    the module's parameters and buffers broadcast from rank 0

and the reductions XLA inserts are explicit:
`training/trainer.py::make_train_step(world=...)` all-reduces the gradients
and the step's stats, and sets the process group on the model's
`models/layers.py::BatchNorm2d`s, which then all-reduce their batch
statistics with autograd. The backend is NCCL for ranks on CUDA devices (rank r
on `cuda:r`) and gloo on the CPU, or for several ranks that share one card.

The rendezvous is a `file://` store in a fresh temporary directory, so that
concurrent worlds on one host never meet, and every collective has a
timeout: a rank that stops makes the others fail after `timeout` seconds
instead of waiting for ever. The JAX module's second `model` axis (spatial
sharding, used by no caller) is not provided.
"""

from __future__ import annotations

import dataclasses
import datetime
import multiprocessing
import os
import pickle
import queue
import tempfile
import traceback
from typing import Any, Callable, List, Mapping, Sequence

import torch
import torch.distributed as dist
from torch import nn

DEFAULT_TIMEOUT = 120.0


@dataclasses.dataclass(frozen=True)
class World:
    """This process's place in the process group: `rank` of `size`."""

    rank: int = 0
    size: int = 1


def init_world(rank: int, size: int, init_file: str, backend: str,
               timeout: float = DEFAULT_TIMEOUT) -> World:
    """Join the process group of `size` ranks that rendezvous at `init_file`
    (a path that does not exist yet; every rank passes the same). NCCL ranks
    use `cuda:<rank>`."""
    if backend == "nccl":
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, init_method=f"file://{init_file}", rank=rank,
                            world_size=size, timeout=datetime.timedelta(seconds=timeout))
    return World(rank, size)


def destroy_world() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def shard_batch(world: World, batch: Mapping[str, Any]) -> dict:
    """Rank `world.rank`'s rows of a global batch: rows [r*B/n, (r+1)*B/n)
    of every leaf with a batch axis; 0-d leaves are replicated. B must be a
    multiple of the world size."""
    out = {}
    for key, value in batch.items():
        if getattr(value, "ndim", 0) == 0:
            out[key] = value
            continue
        rows = value.shape[0]
        if rows % world.size:
            raise ValueError(f"shard_batch: {key!r} has {rows} rows, not a multiple of "
                             f"the world size {world.size}")
        per = rows // world.size
        out[key] = value[world.rank * per:(world.rank + 1) * per]
    return out


def replicate(world: World, module: nn.Module) -> nn.Module:
    """Broadcast `module`'s parameters and buffers from rank 0 to every rank,
    in place; the module is returned."""
    if world.size > 1:
        with torch.no_grad():
            for tensor in list(module.parameters()) + list(module.buffers()):
                dist.broadcast(tensor.data, src=0)
    return module


def all_reduce_grads(params: Sequence[nn.Parameter]) -> None:
    """Sum every parameter's `.grad` over the world, in place, with one
    all-reduce of the gradients flattened into one buffer."""
    grads = [p.grad for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view(g.shape))
        offset += g.numel()


def launch(fn: Callable[..., Any], size: int, args: Sequence[Any] = (), *,
           backend: str, timeout: float = DEFAULT_TIMEOUT, threads: int = 0) -> List[Any]:
    """Run `fn(world, *args)` in `size` spawned processes joined in one
    process group over `backend`, and return the ranks' results in rank
    order. `fn` must be importable by name (a module-level function of a
    package) and return picklable values (CPU tensors, numbers). `threads`
    > 0 sets each rank's intra-op thread count. A rank that raises makes
    `launch` stop the others and raise with its traceback."""
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="centerpose_world_") as tmp:
        init_file = os.path.join(tmp, "rendezvous")
        results = ctx.Queue()
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, rank, size, init_file, backend, timeout, threads, args,
                                   results))
                 for rank in range(size)]
        for p in procs:
            p.start()
        got = {}
        try:
            while len(got) < size:
                try:
                    status, rank, value = results.get(timeout=1.0)
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in got and not p.is_alive()]
                    if dead:
                        raise RuntimeError(f"launch: rank {dead[0]} exited with code "
                                           f"{procs[dead[0]].exitcode} and no result")
                    continue
                if status == "error":
                    raise RuntimeError(f"launch: rank {rank} failed:\n{value}")
                got[rank] = pickle.loads(value)
            for p in procs:
                p.join(timeout=timeout)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(timeout=10)
            results.close()
    return [got[r] for r in range(size)]


def _rank_main(fn, rank, size, init_file, backend, timeout, threads, args, results) -> None:
    """One spawned rank: join the world, run `fn`, report to the parent."""
    if threads > 0:
        torch.set_num_threads(threads)
    try:
        world = init_world(rank, size, init_file, backend, timeout)
        try:
            value = fn(world, *args)
        finally:
            destroy_world()
    except BaseException:
        results.put(("error", rank, traceback.format_exc()))
        raise
    # Pickled here, by value: the queue's pickler would pass a CPU tensor as
    # a file descriptor that dies with this process.
    results.put(("ok", rank, pickle.dumps(value)))
