"""Batch samplers (port of masr_tpu/data/sampler.py):
`BatchShuffleSampler` (:13): the manifest is duration-sorted; epoch 0
with sortagrad keeps that order (a curriculum), later epochs shuffle
whole batches after a random shift, seeded by seed + epoch.
`ShardedBatchSampler` (:57-79) is the data-parallel variant: every rank
draws the same order (same seed + epoch) and takes indices[rank::
num_replicas] before batching."""
import numpy as np


class BatchShuffleSampler(object):
    def __init__(self, dataset_size, batch_size, shuffle=True, drop_last=True,
                 sortagrad=True, seed=0):
        self.size = dataset_size
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.sortagrad = sortagrad
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch):
        self.epoch = epoch

    def _indices(self):
        indices = np.arange(self.size)
        if self.shuffle and not (self.sortagrad and self.epoch == 0):
            rng = np.random.RandomState(self.seed + self.epoch)
            shift = rng.randint(0, self.batch_size)
            batches = [indices[i:i + self.batch_size]
                       for i in range(shift,
                                      len(indices) - self.batch_size + 1,
                                      self.batch_size)]
            rng.shuffle(batches)
            head = indices[:shift]
            tail = indices[shift + len(batches) * self.batch_size:]
            if batches:
                indices = np.concatenate([head] + batches + [tail])
        return indices

    def __iter__(self):
        indices = self._indices()
        for i in range(0, len(indices), self.batch_size):
            batch = indices[i:i + self.batch_size]
            if self.drop_last and len(batch) < self.batch_size:
                break
            yield list(map(int, batch))

    def __len__(self):
        if self.drop_last:
            return self.size // self.batch_size
        return (self.size + self.batch_size - 1) // self.batch_size


class ShardedBatchSampler(BatchShuffleSampler):
    """Rank-strided sharding for data parallelism: every rank draws the
    same shuffled order and takes indices[rank::num_replicas] before
    batching, so the ranks' batches are disjoint. With drop_last every
    rank yields len(self) batches: where the strided shares differ by one
    index, a rank stops with the others (masr_tpu's would yield one batch
    more on the longer ranks, and their collectives would wait on the
    rest)."""

    def __init__(self, dataset_size, batch_size, rank=0, num_replicas=1,
                 **kw):
        super().__init__(dataset_size, batch_size, **kw)
        self.rank = rank
        self.num_replicas = num_replicas

    def __iter__(self):
        indices = self._indices()[self.rank::self.num_replicas]
        if self.drop_last:
            indices = indices[:len(self) * self.batch_size]
        for i in range(0, len(indices), self.batch_size):
            batch = indices[i:i + self.batch_size]
            if self.drop_last and len(batch) < self.batch_size:
                break
            yield list(map(int, batch))

    def __len__(self):
        per_rank = self.size // self.num_replicas
        if self.drop_last:
            return per_rank // self.batch_size
        return (per_rank + self.batch_size - 1) // self.batch_size
