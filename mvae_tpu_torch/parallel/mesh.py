"""The data-parallel group (counterpart of the data-parallel half of
mvae_tpu/parallel/mesh.py and of the mesh policy in
mvae_tpu/train/driver.py:96-103).

The JAX package puts every device into its mesh: the batch axis shards
over gcd(devices, batch) of them, and a leftover factor becomes a "model"
axis of tensor and expert parallelism. The port runs one process a
device, every process a rank of one data-parallel group, each rank
holding the whole model and B / N rows of each batch of B. Where N does
not divide B, the JAX package would hand the leftover factor to tensor
parallelism; the port refuses the run (`data_parallel`).

Not ported yet, for the next slice: the "model" axis, that is
tp_spec_tree, mlp_specs_megatron and shard_params_tp (the Megatron
pairing of the MLP lists and the DCGAN heads, the expert axis of
celeba19's attribute experts), and serving over a data-parallel group.
"""

import math
from typing import NamedTuple

import torch.distributed as dist


class DataParallel(NamedTuple):
    """A data-parallel group: its ranks each hold `world`-th of a batch."""
    group: object       # the torch.distributed process group
    rank: int
    world: int


def data_parallel(batch_size: int, group=None) -> DataParallel:
    """The group (None: the default one) as a DataParallel over batches of
    batch_size rows; SystemExit where its size does not divide them."""
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    check_batch(batch_size, world)
    return DataParallel(dist.group.WORLD if group is None else group, rank,
                        world)


def check_batch(batch_size: int, world: int):
    """SystemExit unless `world` ranks split a batch of batch_size rows
    evenly (the JAX package's tensor-parallel case otherwise)."""
    if batch_size % world:
        dp = math.gcd(batch_size, world)
        raise SystemExit(
            f"--batch-size {batch_size} does not divide over {world} "
            f"processes: the JAX package would run {dp}-way data parallel "
            f"and give the leftover factor {world // dp} to tensor "
            f"parallelism, which is not ported yet; pick a batch size "
            f"divisible by {world}")
