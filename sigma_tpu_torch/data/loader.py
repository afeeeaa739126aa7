"""Multi-threaded prefetching train loader with per-process sharding: the
port's copy of `sigma_tpu/data/loader.py`.

Replaces the reference's torch DataLoader + DistributedSampler (the
reference's `dataloader/dataloader.py:56-89`): each process loads only its
shard of the global batch (`process_index` of `process_count`), matching
the reference's per-rank batch = global_batch / world_size
(dataloader.py:77-80). Decode + augmentation run
in a thread pool (zlib, numpy and torch release the GIL in their large
operations) with a bounded prefetch queue
so host work overlaps device steps.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np


class TrainLoader:
    """Iterable over stacked numpy batches {data, label, modal_x}."""

    def __init__(
        self,
        dataset,
        global_batch_size: int,
        niters_per_epoch: int,
        num_workers: int = 8,
        prefetch: int = 4,
        process_index: int = 0,
        process_count: int = 1,
        seed: int = 0,
    ):
        if global_batch_size % process_count:
            raise ValueError(
                f"global batch {global_batch_size} not divisible by "
                f"{process_count} processes"
            )
        self.dataset = dataset
        self.global_batch_size = global_batch_size
        self.local_batch_size = global_batch_size // process_count
        self.niters_per_epoch = niters_per_epoch
        self.process_index = process_index
        self.process_count = process_count
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.seed = seed
        self._epoch = 0

    def set_epoch(self, epoch: int):
        self._epoch = epoch
        self.dataset.set_epoch(epoch)

    def _load_one(self, epoch, it, slot, perm):
        # deterministic per-(epoch, iter, global slot) augmentation stream
        global_idx = it * self.global_batch_size + slot
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + epoch * 65_537 + global_idx) % (2**63)
        )
        # per-epoch shuffle: all processes derive the same permutation from
        # (seed, epoch), so the global batch partitions it without overlap —
        # the equivalent of the reference's DistributedSampler shuffle
        # (the reference's dataloader/dataloader.py:77-80)
        idx = int(perm[global_idx % len(perm)])
        return self.dataset.__getitem__(idx, rng=rng)

    def __iter__(self):
        epoch = self._epoch
        perm = np.random.default_rng((self.seed, epoch)).permutation(
            len(self.dataset)
        )
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            base = self.process_index * self.local_batch_size
            with ThreadPoolExecutor(self.num_workers) as pool:
                for it in range(self.niters_per_epoch):
                    if stop.is_set():
                        return
                    futs = [
                        pool.submit(self._load_one, epoch, it, base + j, perm)
                        for j in range(self.local_batch_size)
                    ]
                    items = [f.result() for f in futs]
                    batch = {
                        k: np.stack([x[k] for x in items])
                        for k, v in items[0].items()
                        if isinstance(v, np.ndarray)
                    }
                    out_q.put(batch)
            out_q.put(None)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                batch = out_q.get()
                if batch is None:
                    return
                yield batch
        finally:
            stop.set()

    def __len__(self):
        return self.niters_per_epoch
