"""Deterministic batch-index generators: the port's copy of
``ubpl_tpu/data/sampler.py`` (``supervised_epoch_batches``,
``valid_batches``; reference projects/supervised.py:55-58)."""
import numpy as np


def supervised_epoch_batches(labeled_idxs, batch_size,
                             rng: np.random.Generator):
    """SubsetRandomSampler(labeled) + BatchSampler(drop_last=True)."""
    idxs = np.array(labeled_idxs)
    rng.shuffle(idxs)
    n_full = len(idxs) // batch_size
    return [idxs[i * batch_size:(i + 1) * batch_size] for i in range(n_full)]


def valid_batches(n, batch_size):
    """Sequential eval batches; the last one may be smaller."""
    return [np.arange(i, min(i + batch_size, n))
            for i in range(0, n, batch_size)]
