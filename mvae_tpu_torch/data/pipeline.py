"""Host-side input pipeline (the port's copy of mvae_tpu/data/pipeline.py,
numpy only).

Data lives in host numpy arrays, a dict name -> array. The training
driver keeps both sets on the card and draws its batches there
(train/driver.py); the JAX package's host-side `batches` iterator serves
only its host-streaming path, which is not ported yet.
"""

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
