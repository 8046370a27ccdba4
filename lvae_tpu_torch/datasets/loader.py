"""Training data loader, counterpart of ``lvae_tpu/datasets/loader.py``: a
thread-prefetched infinite numpy loader. Sharding is index-based: shard k
of N draws only the positions congruent to k mod N of each epoch's
permutation, re-shuffled every epoch from a shared seed.

Determinism: batch composition and augmentation depend only on
(seed, shard_id, batch_number) — never on thread scheduling. Worker w
builds exactly the batches with number % workers == w from random-access
sampler positions, and the consumer drains per-worker queues round-robin
in batch-number order, so --fixseed runs are bitwise reproducible for any
worker count. start_batch resumes the stream at a batch number: a resumed
run draws the batches the uninterrupted one would have.
"""
import queue
import threading

import numpy as np

__all__ = ['make_trainloader', 'ShardedSampler', 'batch_rng']


def batch_rng(seed, shard_id, bn):
    """The per-batch augmentation rng. Batch `bn` of shard `shard_id` is
    always augmented from this stream, whichever loader builds it: the
    device-resident cache (datasets/device_cache.py) replays the same
    stream to give byte-identical batches."""
    return np.random.default_rng((seed + 1) * 100003 + shard_id * 1009 + bn)


class ShardedSampler:
    """Deterministic per-shard epoch shuffling."""

    def __init__(self, num_items, num_shards=1, shard_id=0, seed=0):
        self.num_items = num_items
        self.num_shards = num_shards
        self.shard_id = shard_id
        self.seed = seed
        self.epoch = 0
        # per-epoch shard length (len(range(shard_id, num_items, num_shards)))
        self.shard_len = len(range(shard_id, num_items, num_shards))
        assert self.shard_len > 0, (
            f'shard {shard_id}/{num_shards} is empty: num_items={num_items} '
            f'< num_shards={num_shards}')
        self._perm_cache = {}          # epoch -> shard permutation

    def epoch_indices(self, epoch):
        # memoized: index_at is called batch_size times per batch in every
        # worker, and a fresh rng.permutation(num_items) per call is O(N)
        cached = self._perm_cache.get(epoch)
        if cached is not None:
            return cached
        rng = np.random.default_rng(self.seed + epoch)
        perm = rng.permutation(self.num_items)
        shard = perm[self.shard_id::self.num_shards]
        if len(self._perm_cache) >= 2:   # workers touch at most 2 epochs
            self._perm_cache.pop(min(self._perm_cache), None)
        self._perm_cache[epoch] = shard
        return shard

    def index_at(self, position):
        """Dataset index at a global stream position (random access)."""
        epoch, off = divmod(int(position), self.shard_len)
        return int(self.epoch_indices(epoch)[off])

    def __iter__(self):
        while True:
            for idx in self.epoch_indices(self.epoch):
                yield int(idx)
            self.epoch += 1

    def set_epoch(self, epoch):
        self.epoch = epoch


def make_trainloader(dataset, batch_size: int, workers: int = 2,
                     num_shards: int = 1, shard_id: int = 0, seed: int = 0,
                     prefetch: int = 4, start_batch: int = 0):
    """Infinite iterator of (B, H, W, 3) batches (the dataset's dtype) from
    batch number `start_batch` on, and its sampler.

    workers: number of loader threads (zlib's inflate releases the GIL).
    Batch `bn` always holds sampler positions [bn*B, (bn+1)*B) augmented
    with rng(seed, shard, bn), whichever thread builds it.
    """
    sampler = ShardedSampler(len(dataset), num_shards, shard_id, seed)
    workers = max(workers, 1)
    per_q = max(prefetch // workers, 1)
    queues = [queue.Queue(maxsize=per_q) for _ in range(workers)]
    stop = threading.Event()

    def build_batch(bn):
        rng = batch_rng(seed, shard_id, bn)
        idxs = [sampler.index_at(bn * batch_size + j)
                for j in range(batch_size)]
        return np.stack([dataset.get(i, rng) for i in idxs])

    def worker(worker_id):
        bn = start_batch + worker_id
        while not stop.is_set():
            batch = build_batch(bn)
            while not stop.is_set():
                try:
                    queues[worker_id].put(batch, timeout=0.5)
                    break
                except queue.Full:
                    continue
            bn += workers

    threads = [threading.Thread(target=worker, args=(w,), daemon=True)
               for w in range(workers)]
    for t in threads:
        t.start()

    class _Loader:
        """Infinite batch iterator with explicit shutdown."""

        def __init__(self):
            self._bn = start_batch

        def __iter__(self):
            return self

        def __next__(self):
            batch = queues[(self._bn - start_batch) % workers].get()
            self._bn += 1
            # epoch bookkeeping (set_epoch/logging parity)
            sampler.epoch = (self._bn * batch_size) // sampler.shard_len
            return batch

        def stop(self):
            stop.set()
            for q in queues:           # unblock producers stuck on put()
                try:
                    q.get_nowait()
                except queue.Empty:
                    pass

    return _Loader(), sampler
