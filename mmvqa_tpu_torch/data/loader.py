"""Threaded prefetching batch loader producing fixed-shape batches
(counterpart of mmvqa_tpu/data/loader.py; the batches stay numpy on the
host, and the step moves them to the card).

Replaces torch DataLoader(num_workers) (roco_train.py:126-127). Design:

* worker threads decode/tokenize samples ahead of the training loop (the
  JPEG decoder and numpy release the GIL for the heavy parts);
* every batch has the same shape: the final partial batch is padded by
  repeating samples and carries a ``weights`` vector (1 real / 0 pad) so
  that metrics and losses mask padding exactly;
* optional in-RAM decoded-image cache for small datasets (VQA-Med fits);
* per-rank sharding (``shard_index/shard_count``, the strided split of the
  JAX loader): every shard yields the same number of batches, the largest
  shard's, a shorter one padding with batches of weight 0, so that the data
  ranks of a layout step together.
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from queue import Queue
from typing import Dict, Iterator, Optional

import numpy as np

from mmvqa_tpu_torch.data.images import RamImageCache


class BatchLoader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = False,
        seed: int = 0,
        num_workers: int = 4,
        drop_last: bool = False,
        cache_images: bool = False,
        shard_index: int = 0,
        shard_count: int = 1,
        prefetch: int = 2,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.shard_index = shard_index
        self.shard_count = shard_count
        self.prefetch = prefetch
        self.epoch = 0
        self._cache: Optional[dict] = None
        if cache_images:
            if (getattr(dataset, "mode", None) == "train"
                    and hasattr(dataset, "image_cache")):
                # sample-level caching would FREEZE the per-epoch randomness
                # (host rotation, MLM masks, back-translation pick) — cache
                # only the deterministic decode on the dataset instead
                if dataset.image_cache is None:
                    dataset.image_cache = RamImageCache()
                elif not isinstance(dataset.image_cache, RamImageCache):
                    # both --cache_images and --image_cache_dir: layer RAM
                    # over the disk cache (disk alone would serve warm
                    # epochs ~3x slower than RAM)
                    dataset.image_cache = RamImageCache(
                        backing=dataset.image_cache
                    )
            else:
                self._cache = {}

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:  # the smallest shard's full batches
            return (n // self.shard_count) // self.batch_size
        return -(-(-(-n // self.shard_count)) // self.batch_size)

    def _indices(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shard_count > 1:
            idx = idx[self.shard_index :: self.shard_count]
        return idx

    def _get(self, i: int) -> Dict[str, np.ndarray]:
        if self._cache is not None and i in self._cache:
            return self._cache[i]
        s = self.dataset[int(i)]
        if self._cache is not None:
            self._cache[i] = s
        return s

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        idx = self._indices()
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(idx)
        self.epoch += 1

        batches = []
        for start in range(0, len(idx), self.batch_size):
            chunk = idx[start : start + self.batch_size]
            if len(chunk) < self.batch_size:
                if self.drop_last:
                    continue
                pad = np.resize(chunk, self.batch_size - len(chunk))
                weights = np.concatenate(
                    [np.ones(len(chunk), np.float32),
                     np.zeros(self.batch_size - len(chunk), np.float32)]
                )
                chunk = np.concatenate([chunk, pad])
            else:
                weights = np.ones(self.batch_size, np.float32)
            batches.append((chunk, weights))
        batches = batches[:len(self)]
        while len(batches) < len(self):  # a short shard steps with the rest
            batches.append((np.zeros(self.batch_size, np.int64),
                            np.zeros(self.batch_size, np.float32)))

        q: Queue = Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def produce():
            with ThreadPoolExecutor(self.num_workers) as pool:
                for chunk, weights in batches:
                    if stop.is_set():
                        return
                    samples = list(pool.map(self._get, chunk))
                    batch = {
                        k: np.stack([s[k] for s in samples])
                        for k in samples[0]
                        if not isinstance(samples[0][k], str)
                    }
                    # string fields (captions for SupCon masks) stay lists
                    for k in samples[0]:
                        if isinstance(samples[0][k], str):
                            batch[k] = [s[k] for s in samples]
                    batch["weights"] = weights
                    if self.shard_count > 1:
                        # rows gathered across the shards find their place
                        # in the dataset by it (trainer.vqa_epoch)
                        batch["index"] = np.asarray(chunk, np.int64)
                    q.put(batch)
            q.put(None)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    return
                yield batch
        finally:
            stop.set()
