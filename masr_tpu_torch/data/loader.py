"""Prefetching data loader (port of masr_tpu/data/loader.py:17): worker
threads featurize utterances (numpy FFTs and products release the GIL) and
a bounded queue keeps `prefetch` collated batches ready."""
import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from masr_tpu_torch.data.collate import collate_fn


class DataLoader(object):
    def __init__(self, dataset, batch_sampler, num_workers=4, prefetch=4,
                 feature_bucket=16, label_bucket=8, seed=0):
        self.dataset = dataset
        self.batch_sampler = batch_sampler
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.feature_bucket = feature_bucket
        self.label_bucket = label_bucket
        self._rng = np.random.RandomState(seed)

    def __len__(self):
        return len(self.batch_sampler)

    def __iter__(self):
        q = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def produce():
            with ThreadPoolExecutor(self.num_workers) as pool:
                try:
                    for batch_idx in self.batch_sampler:
                        if stop.is_set():
                            break
                        items = list(pool.map(self.dataset.__getitem__,
                                              batch_idx))
                        q.put(collate_fn(items, self.feature_bucket,
                                         self.label_bucket, rng=self._rng))
                except Exception as e:   # surface worker errors
                    q.put(e)
                finally:
                    q.put(None)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            # let a producer blocked on a full queue see the stop
            while t.is_alive():
                try:
                    q.get(timeout=0.05)
                except queue.Empty:
                    pass
