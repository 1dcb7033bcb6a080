"""Deterministic batch-index generators: the port's copy of
``ubpl_tpu/data/sampler.py`` (``supervised_epoch_batches``,
``TwoStreamBatchSampler``, ``valid_batches``; reference
projects/supervised.py:55-58 and utils/mt/data.py:105-132).  All draws come
from a numpy ``Generator``, so one seed gives the JAX package's batches."""
import itertools

import numpy as np


def supervised_epoch_batches(labeled_idxs, batch_size,
                             rng: np.random.Generator):
    """SubsetRandomSampler(labeled) + BatchSampler(drop_last=True)."""
    idxs = np.array(labeled_idxs)
    rng.shuffle(idxs)
    n_full = len(idxs) // batch_size
    return [idxs[i * batch_size:(i + 1) * batch_size] for i in range(n_full)]


class TwoStreamBatchSampler:
    """Reference two-stream sampler: each batch is
    ``batch_size - secondary_batch_size`` primary (unlabeled) indices, one
    pass per epoch, followed by ``secondary_batch_size`` secondary (labeled)
    indices from a stream that reshuffles and cycles for ever."""

    def __init__(self, primary_indices, secondary_indices, batch_size,
                 secondary_batch_size, rng: np.random.Generator):
        self.primary = np.array(primary_indices)
        self.secondary = np.array(secondary_indices)
        self.secondary_bs = secondary_batch_size
        self.primary_bs = batch_size - secondary_batch_size
        assert len(self.primary) >= self.primary_bs > 0
        assert len(self.secondary) >= self.secondary_bs > 0
        self.rng = rng

    def __len__(self):
        return len(self.primary) // self.primary_bs

    def _iterate_eternally(self):
        while True:
            idxs = self.secondary.copy()
            self.rng.shuffle(idxs)
            yield from idxs

    def __iter__(self):
        prim = self.primary.copy()
        self.rng.shuffle(prim)
        sec = self._iterate_eternally()
        for b in range(len(self)):
            p = prim[b * self.primary_bs:(b + 1) * self.primary_bs]
            s = np.fromiter(itertools.islice(sec, self.secondary_bs),
                            dtype=prim.dtype, count=self.secondary_bs)
            yield np.concatenate([p, s])


def valid_batches(n, batch_size):
    """Sequential eval batches; the last one may be smaller."""
    return [np.arange(i, min(i + batch_size, n))
            for i in range(0, n, batch_size)]
