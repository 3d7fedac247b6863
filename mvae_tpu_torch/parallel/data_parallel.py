"""Data parallelism with per-replica BN statistics (counterpart of
mvae_tpu/parallel/data_parallel.py, its shard_map steps).

The default data-parallel step (train/loop.py, dp=...) shares the BN
batch statistics across the ranks, so its values are one device's on the
whole batch. This is the explicit alternative: each rank's BNs normalize
with its own rows' statistics, as in large-scale training with
per-replica BatchNorm; the gradients and the loss are averaged across the
ranks, and so are the BN running statistics after the step, so that the
replicas stay equal (JAX's pmean of grads, loss and new_state,
data_parallel.py:44-47). A rank draws the noise of the global batch and
keeps its rows, so the ranks' noise differs (JAX folds the shard index
into its key). No CLI uses it, as in the JAX package.
"""

import torch

from mvae_tpu_torch.nn.norm import BatchNorm
from mvae_tpu_torch.parallel.collectives import sum_in_place
from mvae_tpu_torch.train import loop as L


def average_running_stats(model, dp):
    """The BNs' running means and variances averaged across the ranks, in
    one all-reduce over a flat buffer."""
    bufs = [b for m in model.modules() if isinstance(m, BatchNorm)
            for b in (m.running_mean, m.running_var)]
    flat = sum_in_place(dp.group, torch.cat(bufs)).div_(dp.world)
    for b, v in zip(bufs, flat.split([b.numel() for b in bufs])):
        b.copy_(v)


def make_replica_train_step(model, term_masks, term_lambdas, *, lr: float,
                            generator, dp, device=None, **step_kw):
    """train/loop.py:make_train_step under `dp` with each rank's BN
    statistics its own; returns (loss, per_term) averaged across the ranks.
    step_kw: make_train_step's other keywords."""
    step = L.make_train_step(model, term_masks, term_lambdas, lr=lr,
                             generator=generator, device=device, dp=dp,
                             sync_bn=False, **step_kw)

    def replica_step(batch, beta, noise=None, **terms):
        loss, per_term = step(batch, beta, noise, **terms)
        with torch.no_grad():
            average_running_stats(model, dp)
        out = sum_in_place(dp.group, torch.cat([loss[None], per_term]))
        out = out.div_(dp.world)
        return out[0], out[1:]

    replica_step.optimizer = step.optimizer
    return replica_step


def make_replica_eval_step(model, term_masks, term_lambdas, *, dp,
                           device=None, **eval_kw):
    """train/loop.py:make_eval_step on each rank's rows, the loss and the
    per-term values averaged across the ranks (data_parallel.py:58-70)."""
    step = L.make_eval_step(model, term_masks, term_lambdas, device=device,
                            **eval_kw)

    def replica_eval(batch):
        total, per_term = step(batch)
        out = sum_in_place(dp.group, torch.cat([total[None], per_term]))
        out = out.div_(dp.world)
        return out[0], out[1:]

    return replica_eval
