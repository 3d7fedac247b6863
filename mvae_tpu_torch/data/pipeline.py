"""Host-side input pipeline (the port's copy of mvae_tpu/data/pipeline.py,
numpy only).

Data lives in host numpy arrays, a dict name -> array. The training
driver keeps both sets on the card and draws its batches there
(train/driver.py); `batches`, the host-side iterator, feeds the
log-likelihood CLI (train/loglike_cli.py). The JAX package's native C++
row gather is not ported (numpy's fancy indexing gathers), nor is its
host-streaming training path (--no-device-data).
"""

import numpy as np


def warn_synthetic(dataset: str, root: str):
    """One loud line when a loader falls back to synthetic data, so a
    mistyped --data-dir cannot silently train on the fallback set."""
    print(f"[mvae_tpu_torch.data] {dataset}: no real data under {root!r} — "
          f"using the deterministic synthetic fallback")


class ArrayDataset:
    """dict of parallel numpy arrays, first axis = examples."""

    def __init__(self, arrays: dict):
        ns = {len(v) for v in arrays.values()}
        if len(ns) != 1:
            raise ValueError(f"modalities must be parallel, got lengths "
                             f"{sorted(ns)}")
        self.arrays = arrays
        self.n = ns.pop()

    def __len__(self):
        return self.n


def num_batches(n: int, batch_size: int, drop_remainder: bool) -> int:
    return n // batch_size if drop_remainder else -(-n // batch_size)


def batches(ds: ArrayDataset, batch_size: int, *, shuffle: bool,
            seed: int = 0, epoch: int = 0, drop_remainder: bool = None):
    """Yield dict batches (mvae_tpu/data/pipeline.py:35-49): shuffled per
    epoch with the ragged tail dropped for training, in order with the
    tail kept otherwise."""
    if drop_remainder is None:
        drop_remainder = shuffle
    idx = np.arange(ds.n)
    if shuffle:
        rng = np.random.default_rng(np.random.SeedSequence([seed, epoch]))
        rng.shuffle(idx)
    stop = ds.n - (ds.n % batch_size) if drop_remainder else ds.n
    for i in range(0, stop, batch_size):
        take = idx[i:i + batch_size]
        yield {k: v[take] for k, v in ds.arrays.items()}
