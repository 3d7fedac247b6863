"""Multi-process start-up and per-rank feeding (counterpart of
mvae_tpu/parallel/distributed.py).

* `maybe_initialize(args)` starts the default torch.distributed process
  group from `--coordinator host:port --process-id i --n-processes N`, or
  from a bare `--distributed` with the environment that `torchrun` sets
  (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT, LOCAL_RANK,
  LOCAL_WORLD_SIZE). It returns (rank, world), (0, 1) when nothing asks
  for distribution, and does nothing when the group is already up. Every
  rendezvous and collective has a time limit (`timeout`), so that a rank
  that never arrives fails the others instead of hanging them.
* The device of a rank is cuda:(LOCAL_RANK % device_count) unless
  --device names one; the backend follows from it, by rule: NCCL where the
  ranks of the node each have a card of their own, gloo on the CPU and
  where ranks share a card (NCCL refuses two ranks on one device). Gloo
  all-reduces CUDA tensors through the host.
* `process_rows` and `local_rows`: every rank holds the same global batch
  (same seed, same loader) and keeps its contiguous block of rows, rank r
  of N rows [r * n / N, (r + 1) * n / N), as the JAX package's
  process-major mesh does (global_batch_tree, data/pipeline.py:
  shard_batch).

The ranks form the (data, model) grid of parallel/mesh.py: where N does
not divide the batch, the leftover factor is tensor and expert
parallelism, on one node only (LOCAL_WORLD_SIZE, or all N ranks where
--coordinator starts them without it), as the JAX package allows it
within one process's devices only; `process_rows` and `local_rows` then
take the dp index and size.
"""

import datetime
import os

import torch
import torch.distributed as dist

from mvae_tpu_torch.parallel.mesh import check_batch

TIMEOUT = datetime.timedelta(minutes=10)


def _env_int(name):
    v = os.environ.get(name)
    return None if v is None else int(v)


def rank_device(device, local_rank: int) -> torch.device:
    """The device rank `local_rank` of its node runs on: `device` if given
    (the --device flag), else cuda:(local_rank % device_count); the CPU
    only when asked for."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu "
                           "to run the ranks on the CPU")
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def choose_backend(device: torch.device, local_world: int) -> tuple:
    """(backend, why): NCCL where each of the node's local_world ranks has
    a card of its own, gloo otherwise."""
    if device.type != "cuda":
        return "gloo", "ranks on the CPU"
    cards = torch.cuda.device_count()
    if local_world > cards:
        return "gloo", f"{local_world} ranks share {cards} card(s)"
    return "nccl", f"a card a rank ({local_world} on this node)"


def maybe_initialize(args=None, *, timeout=TIMEOUT):
    """Start the default process group where args (or the environment)
    ask for it; returns (rank, world). Sets this rank's CUDA device, so
    that device=None resolves to it (device.py:resolve_device)."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    coord = getattr(args, "coordinator", None)
    bare = bool(getattr(args, "distributed", False))
    if not (coord or bare):
        return 0, 1
    if coord:
        rank = getattr(args, "process_id", None)
        world = getattr(args, "n_processes", None)
        rank = _env_int("RANK") if rank is None else rank
        world = _env_int("WORLD_SIZE") if world is None else world
        address = coord
    else:
        rank, world = _env_int("RANK"), _env_int("WORLD_SIZE")
        host, port = os.environ.get("MASTER_ADDR"), os.environ.get(
            "MASTER_PORT")
        address = None if host is None or port is None else f"{host}:{port}"
    if rank is None or world is None or address is None:
        raise SystemExit(
            "distributed: give --coordinator host:port --process-id i "
            "--n-processes N, or run under torchrun (RANK, WORLD_SIZE, "
            "MASTER_ADDR, MASTER_PORT)")
    if not 0 <= rank < world:
        raise SystemExit(f"distributed: process id {rank} is not in "
                         f"[0, {world})")
    local_rank = _env_int("LOCAL_RANK")
    local_rank = rank if local_rank is None else local_rank
    local_world = _env_int("LOCAL_WORLD_SIZE") or world
    if getattr(args, "batch_size", None) is not None:
        # before the rendezvous
        check_batch(args.batch_size, world, local_world)
    device = rank_device(getattr(args, "device", None), local_rank)
    backend, why = choose_backend(device, local_world)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=f"tcp://{address}",
                            rank=rank, world_size=world, timeout=timeout)
    if rank == 0:
        print(f"process group of {world} ranks up: {backend} ({why}); "
              f"rank 0 on {device}")
    return rank, world


def is_coordinator() -> bool:
    """Rank 0, or a run with no process group: the one that logs and
    writes files."""
    return not dist.is_initialized() or dist.get_rank() == 0


def process_rows(n_rows: int, rank: int, world: int) -> tuple:
    """(start, stop): rank's contiguous block of n_rows rows, an equal
    share; raises unless world divides n_rows."""
    if n_rows % world:
        raise ValueError(f"{n_rows} rows do not split evenly over {world} "
                         f"processes")
    share = n_rows // world
    return rank * share, (rank + 1) * share


def local_rows(batch: dict, rank: int, world: int) -> dict:
    """The rank's block of rows of a global batch (name -> rows)."""
    n = len(next(iter(batch.values())))
    lo, hi = process_rows(n, rank, world)
    return {k: v[lo:hi] for k, v in batch.items()}
