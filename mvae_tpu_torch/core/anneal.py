"""KL annealing schedule (the port's copy of mvae_tpu/core/anneal.py).

Linear warmup 0 -> 1 over `annealing_epochs`, indexed by the global batch
counter, then held at 1.0 (reference mnist/train.py:180-186):

    beta = (batch_idx + (epoch-1) * N_batches + 1) / (annealing_epochs * N_batches)
"""

import torch


def annealing_factor(epoch: int, batch_idx: int, n_batches: int,
                     annealing_epochs: int) -> float:
    if annealing_epochs <= 0 or epoch >= annealing_epochs:
        return 1.0
    return float(batch_idx + (epoch - 1) * n_batches + 1) / \
        float(annealing_epochs * n_batches)


def annealing_factor_from_step(global_step, n_batches, annealing_epochs):
    """The same from global_step = batch_idx + (epoch-1) * n_batches, an int
    or a tensor of steps. beta snaps to 1.0 at the first batch of epoch
    `annealing_epochs`, as the reference's epoch threshold does."""
    beta = (global_step + 1.0) / (annealing_epochs * n_batches)
    done = global_step >= (annealing_epochs - 1) * n_batches
    if torch.is_tensor(global_step):
        return torch.where(done, 1.0, beta)
    return 1.0 if done else beta
