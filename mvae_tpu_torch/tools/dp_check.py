"""Hold the data-parallel train step against one process: a window of K
train steps replayed on N spawned ranks and in this process alone.

A recipe (`recipe(...)`) holds a model (its class, arguments and
state_dict), the step's settings and a window: the K global batches of B
rows each, their KL weights and, optionally, the global noise (else each
replay draws it from a generator of the recipe's seed) and celeba19's
per-step terms. `replay(recipe, device, dp)` runs the window through
train/loop.py:make_multi_train_step, rank dp.rank holding its B / N rows
of each batch resident; with dp=None it is the single process on the
whole batches. `spawn_ranks(world, replay_all, recipes)` spawns `world`
processes, a gloo or NCCL group as parallel/distributed.py chooses (ranks
that share a card use gloo), replays every recipe on each and returns
their outcomes.
An outcome: after each of the recipe's windows (dispatches) the window's
losses (this rank's), the parameters, their gradients at its last step
(after the all-reduce) and the BN running statistics; and the kernel
launches and all-reduces of the whole replay.

A recipe with sync_bn=False replays the per-replica step
(parallel/data_parallel.py) instead, one step at a time.
"""

import datetime
import multiprocessing
import os
import tempfile

import torch
import torch.distributed as dist

from mvae_tpu_torch import ops
from mvae_tpu_torch.device import resolve_device
from mvae_tpu_torch.nn.norm import BatchNorm
from mvae_tpu_torch.parallel.collectives import all_reduce_sum
from mvae_tpu_torch.parallel.data_parallel import make_replica_train_step
from mvae_tpu_torch.parallel.distributed import choose_backend, rank_device
from mvae_tpu_torch.parallel.mesh import data_parallel
from mvae_tpu_torch.train.loop import make_multi_train_step

TIMEOUT_S = 300


def recipe(model_class, model_args, model_kw, state_dict, data, betas, *,
           step_kw, noise=None, masks=None, lambdas=None, seed=0,
           sync_bn=True, windows=None, name=""):
    """A window to replay. data: name -> (K * B, ...) CPU rows, step k's
    batch rows [k * B, (k + 1) * B); betas (K,); noise: the K steps'
    global noise ((K, T, B, D) eps, ...) or None; masks, lambdas: (K, T,
    M) or None; step_kw: make_multi_train_step's keywords (term_masks,
    term_lambdas, lr, ...); model_kw without device. windows: the steps
    of each dispatch, summing to K (default: one of K), with a snapshot
    of the outcome after each."""
    k = len(betas)
    return dict(model=(model_class, tuple(model_args), dict(model_kw)),
                state_dict={n: v.detach().cpu() for n, v in
                            state_dict.items()},
                data=data, betas=betas, noise=noise, masks=masks,
                lambdas=lambdas, seed=seed, step_kw=step_kw,
                sync_bn=sync_bn, windows=tuple(windows or (k,)), name=name)


def _rows(data, k, b, lo):
    """Rows lo .. lo + b of each of the k batches of data, stacked."""
    rows = len(next(iter(data.values()))) // k
    idx = (torch.arange(k)[:, None] * rows + lo
           + torch.arange(b)[None]).reshape(-1)
    return {n: v.index_select(0, idx) for n, v in data.items()}


def _copy(t):
    return None if t is None else t.detach().to("cpu", copy=True)


def _snapshot(model, losses):
    return dict(
        losses=_copy(losses),
        params={n: _copy(p) for n, p in model.named_parameters()},
        grads={n: _copy(p.grad) for n, p in model.named_parameters()},
        running={n: _copy(v) for n, v in model.state_dict().items()
                 if n.endswith(("running_mean", "running_var"))})


def replay(rc, device, dp=None) -> dict:
    """Run recipe rc on `device` as rank dp.rank of dp (None: alone):
    {"name", "windows": [a snapshot after each window: the window's
    losses (this rank's), the parameters, their gradients at its last
    step, the running statistics], "n_bn", "launches", "all_reduces"}."""
    cls, args, kw = rc["model"]
    model = cls(*args, device=device, **kw)
    model.load_state_dict({n: v.to(device) for n, v in
                           rc["state_dict"].items()}, strict=True)
    k = len(rc["betas"])
    world, rank = (1, 0) if dp is None else (dp.world, dp.rank)
    b = len(next(iter(rc["data"].values()))) // k // world
    data = {n: v.to(device) for n, v in
            _rows(rc["data"], k, b, rank * b).items()}
    idxs = torch.arange(k * b, device=device).reshape(k, b)

    def window(lo, hi, v):
        """Steps lo .. hi - 1 of a (K, ...) tensor, on the device."""
        return None if v is None else v[lo:hi].to(device)

    gen = torch.Generator(device=device).manual_seed(rc["seed"])
    launches0, calls0 = ops.launch_counts(), all_reduce_sum.calls
    if rc["sync_bn"]:
        step = make_multi_train_step(model, generator=gen, device=device,
                                     dp=dp, **rc["step_kw"])
    else:
        one = make_replica_train_step(model, generator=gen, device=device,
                                      dp=dp, device_data=True,
                                      **rc["step_kw"])

        def step(data, idxs, betas, noise=None, **terms):
            return torch.stack([one(
                (data, idxs[i]), betas[i],
                None if noise is None else tuple(
                    None if n is None else n[i] for n in noise),
                **{n: v[i] for n, v in terms.items()})[0]
                for i in range(len(idxs))])
    out, lo = [], 0
    for kk in rc["windows"]:
        hi = lo + kk
        noise = None if rc["noise"] is None else tuple(
            window(lo, hi, n) for n in rc["noise"])
        terms = ({} if rc["masks"] is None else
                 dict(masks=window(lo, hi, rc["masks"]),
                      lambdas=window(lo, hi, rc["lambdas"])))
        losses = step(data, idxs[lo:hi], window(lo, hi, rc["betas"]),
                      noise=noise, **terms)
        out.append(_snapshot(model, losses))
        lo = hi
    return dict(name=rc["name"], windows=out,
                n_bn=sum(isinstance(m, BatchNorm) for m in model.modules()),
                launches={k: v - launches0[k]
                          for k, v in ops.launch_counts().items()},
                all_reduces=all_reduce_sum.calls - calls0)


def _rank_main(fn, rank, world, store, payload_path, device, out_dir,
               timeout_s, tf32):
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    cudnn.allow_tf32, matmul.allow_tf32 = tf32
    dev = rank_device(device, rank)
    if dev.type == "cpu":
        torch.set_num_threads(1)
    else:
        torch.cuda.set_device(dev)
    dev = resolve_device(dev)
    backend, _ = choose_backend(dev, world)
    dist.init_process_group(backend, init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    try:
        # the payload is this process's parent's own file
        out = fn(torch.load(payload_path, weights_only=False), dev)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn_ranks(world: int, fn, payload, *, device=None,
                timeout_s: int = TIMEOUT_S) -> list:
    """Run fn(payload, device) on `world` spawned ranks of a fresh default
    process group, each on its device (`device`, or None: the card,
    cuda:(rank % cards)), the backend by parallel/distributed.py's rule;
    returns their results in rank order. The ranks take this process's
    TF32 settings (cuDNN's and cuBLAS's). fn must be importable (spawn
    pickles it by name) and its result picklable. Raises if a rank fails
    or outlasts timeout_s."""
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="dp_check_") as tmp:
        path = os.path.join(tmp, "payload.pt")
        torch.save(payload, path)
        procs = [ctx.Process(target=_rank_main, args=(
            fn, r, world, os.path.join(tmp, "store"), path, device, tmp,
            timeout_s, (torch.backends.cudnn.allow_tf32,
                        torch.backends.cuda.matmul.allow_tf32)))
            for r in range(world)]
        for p in procs:
            p.start()
        try:
            for p in procs:
                p.join(timeout_s)
        finally:
            hung = [p for p in procs if p.is_alive()]
            for p in hung:
                p.kill()
                p.join(10)
        if hung:
            raise TimeoutError(f"{len(hung)} of {world} ranks still ran "
                               f"after {timeout_s} s")
        failed = [r for r, p in enumerate(procs) if p.exitcode != 0]
        if failed:
            raise RuntimeError(f"ranks {failed} failed (exit codes "
                               f"{[procs[r].exitcode for r in failed]})")
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]


def replay_all(recipes, device) -> list:
    """Every recipe replayed on this rank of the default group: the rank
    function of spawn_ranks(world, replay_all, recipes), whose result
    outs[rank][i] is recipe i's outcome on that rank."""
    outs = []
    for rc in recipes:
        rows = len(next(iter(rc["data"].values()))) // len(rc["betas"])
        outs.append(replay(rc, device, data_parallel(rows)))
    return outs

