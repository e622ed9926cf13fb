"""Parallel, prefetching data loader — torch DataLoader analogue.

Parity target: `torch.utils.data.DataLoader(dataset, batch_size, shuffle=True,
num_workers=opt.num_workers, pin_memory=True, drop_last=True)` as used by the
reference training entry (src/main_CenterPose.py:70-78):
  * batch-level parallel workers with a BOUNDED prefetch queue (host
    augmentation overlaps the accelerator step instead of serializing with it);
  * per-worker seeding: worker w gets `base_seed + worker_id` (torch's
    worker_init convention) through a private shallow copy of the dataset, so
    augmentation streams are independent AND reproducible;
  * None filtering via collate (corrupt samples dropped, dataset_factory.py:8-14);
  * ordered delivery (batches yield in sampler order regardless of worker
    completion order);
  * epoch-dependent shuffling via `set_epoch` (stable resume).

Workers default to threads: the host augmentation stack is numpy-dominated
(warps, gaussian renders) which releases the GIL, and the test image has one
core; `mode="process"` uses spawn-based worker processes for multi-core hosts.

The PyTorch package's own copy of `centerpose_tpu/data/loader.py`: the same
order, shuffles, worker RNG streams and error paths.

Data parallel (`rank`, `world` > 1; `train.py --num_devices`): every rank
draws the same global index batches (the permutation of `seed + epoch`) and
loads rows [rank*B/world, (rank+1)*B/world) of each, the rows
`parallel/mesh.py::shard_batch` gives it, with its own rng streams; rank 0's
streams are those of a one-process loader. It yields one item per global
batch, `None` where its slice lost every sample (or is empty, in the short
last batch of `drop_last=False`), so that the ranks stay in step.
"""

from __future__ import annotations

import copy
import threading
from typing import Callable, Iterator, Optional, Sequence

import numpy as np

from centerpose_tpu_torch.data.dataset import collate_filtered


class DataLoader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        num_workers: int = 2,
        seed: int = 317,
        prefetch: int = 4,
        drop_last: bool = True,
        collate_fn: Callable = collate_filtered,
        mode: str = "thread",
        rank: int = 0,
        world: int = 1,
    ):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.num_workers = int(num_workers)
        self.seed = int(seed)
        self.prefetch = max(1, int(prefetch))
        self.drop_last = drop_last
        self.collate_fn = collate_fn
        self.mode = mode
        self.rank = int(rank)
        self.world = int(world)
        if self.batch_size % self.world:
            raise ValueError(f"DataLoader: batch_size {self.batch_size} is not a multiple of "
                             f"the world size {self.world}")
        self._epoch = 0

    def set_epoch(self, epoch: int):
        self._epoch = int(epoch)

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    # ------------------------------------------------------------------ sampler
    def index_batches(self) -> Sequence[np.ndarray]:
        """This epoch's index batches: the global batches, or with `world`
        > 1 this rank's slice of each."""
        batches = self._global_batches()
        if self.world == 1:
            return batches
        per = self.batch_size // self.world
        return [b[self.rank * per:(self.rank + 1) * per] for b in batches]

    def _global_batches(self) -> Sequence[np.ndarray]:
        n = len(self.dataset)
        if self.shuffle:
            order = np.random.RandomState(self.seed + self._epoch).permutation(n)
        else:
            order = np.arange(n)
        stop = (n // self.batch_size) * self.batch_size if self.drop_last else n
        return [
            order[i:i + self.batch_size]
            for i in range(0, stop, self.batch_size)
            if not self.drop_last or i + self.batch_size <= n
        ]

    def _worker_seed(self, worker_id: int) -> int:
        return (self.seed + 1000 * (self._epoch + 1) + self.rank * max(1, self.num_workers)
                + worker_id)

    def _worker_dataset(self, worker_id: int):
        """Private shallow copy with an independent, reproducible rng stream."""
        ds = copy.copy(self.dataset)
        if hasattr(ds, "rng"):
            ds.rng = np.random.RandomState(self._worker_seed(worker_id))
        return ds

    def _load_batch(self, ds, indices) -> Optional[dict]:
        samples = []
        for i in indices:
            item = ds[int(i)]
            if item is None:
                continue
            item.pop("meta", None)
            samples.append(item)
        if not samples:
            return None
        return self.collate_fn(samples)

    # ------------------------------------------------------------------ iterate
    def __iter__(self) -> Iterator[dict]:
        batches = self.index_batches()
        if self.num_workers <= 0:
            ds = self._worker_dataset(0)
            for idxs in batches:
                out = self._load_batch(ds, idxs)
                if out is not None or self.world > 1:
                    yield out
            return
        if self.mode == "process":
            yield from self._iter_processes(batches)
        else:
            yield from self._iter_threads(batches)

    def _iter_threads(self, batches) -> Iterator[dict]:
        done: dict = {}
        cond = threading.Condition()
        # Bounded prefetch: workers stall while `prefetch` finished batches
        # sit unconsumed (the consumer advances `next_out`).
        state = {"next_out": 0}
        stop = threading.Event()

        def worker(wid: int):
            # Deterministic round-robin batch assignment (torch's convention):
            # worker w handles batches w, w+W, w+2W, ... so each worker's rng
            # stream is consumed in a schedule-independent order and epochs
            # replay bit-exactly regardless of thread timing.
            ds = self._worker_dataset(wid)
            for bi in range(wid, len(batches), self.num_workers):
                if stop.is_set():
                    return
                try:
                    out = self._load_batch(ds, batches[bi])
                except Exception as e:  # propagate instead of hanging the consumer
                    out = _WorkerError(e)
                with cond:
                    while (
                        bi - state["next_out"] >= self.prefetch
                        and not stop.is_set()
                    ):
                        cond.wait(timeout=0.5)
                    done[bi] = out
                    cond.notify_all()
                if isinstance(out, _WorkerError):
                    return

        threads = [
            threading.Thread(target=worker, args=(w,), daemon=True)
            for w in range(self.num_workers)
        ]
        for t in threads:
            t.start()
        try:
            for bi in range(len(batches)):
                with cond:
                    while bi not in done:
                        cond.wait(timeout=0.5)
                    out = done.pop(bi)
                    state["next_out"] = bi + 1
                    cond.notify_all()
                if isinstance(out, _WorkerError):
                    raise RuntimeError(
                        f"DataLoader worker failed on batch {bi}"
                    ) from out.exc
                if out is not None or self.world > 1:
                    yield out
        finally:
            stop.set()
            with cond:
                cond.notify_all()
            for t in threads:
                t.join(timeout=5)

    def _iter_processes(self, batches) -> Iterator[dict]:
        import multiprocessing as mp

        ctx = mp.get_context("spawn")
        # Same deterministic round-robin assignment as the thread path: worker
        # w owns batches w::W, so its rng stream replays identically per epoch.
        # One bounded queue PER worker: the consumer always pops the owning
        # worker's queue for the next in-order batch (FIFO within a worker), so
        # a slow worker backpressures only itself — no unbounded reorder
        # buffer when workers run at different speeds.
        queues = [ctx.Queue(maxsize=self.prefetch)
                  for _ in range(self.num_workers)]
        procs = [
            ctx.Process(
                target=_process_worker,
                args=(self.dataset, self.collate_fn,
                      [(bi, np.asarray(batches[bi]))
                       for bi in range(w, len(batches), self.num_workers)],
                      queues[w], self._worker_seed(w)),
                daemon=True,
            )
            for w in range(self.num_workers)
        ]
        for p in procs:
            p.start()
        import queue as _queue

        try:
            for bi in range(len(batches)):
                w = bi % self.num_workers
                while True:
                    try:
                        tag, out = queues[w].get(timeout=5)
                        break
                    except _queue.Empty:
                        if not procs[w].is_alive():
                            raise RuntimeError(
                                f"DataLoader worker {w} died (exitcode "
                                f"{procs[w].exitcode}) before batch {bi}"
                            ) from None
                if tag == "error":
                    raise RuntimeError(
                        f"DataLoader worker {w} failed on batch {bi}: {out}"
                    )
                if out is not None or self.world > 1:
                    yield out
        finally:
            for p in procs:
                p.terminate()
            for p in procs:
                p.join(timeout=5)


def _process_worker(dataset, collate_fn, tasks, out_q, seed):
    if hasattr(dataset, "rng"):
        dataset.rng = np.random.RandomState(seed)
    for bi, idxs in tasks:
        try:
            samples = []
            for i in idxs:
                item = dataset[int(i)]
                if item is None:
                    continue
                item.pop("meta", None)
                samples.append(item)
            out_q.put(("ok", collate_fn(samples) if samples else None))
        except Exception as e:  # surface in the consumer instead of hanging it
            import traceback

            out_q.put(("error", f"{e}\n{traceback.format_exc()}"))
            return


class _WorkerError:
    """Sentinel carrying a worker exception across the thread boundary."""

    def __init__(self, exc: Exception):
        self.exc = exc
