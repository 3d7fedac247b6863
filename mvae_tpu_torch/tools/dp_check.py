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
their outcomes. The ranks form the grid of parallel/mesh.py over the
recipe's global batch: where `world` does not divide B, the leftover
factor is a model axis (tensor and expert parallelism), each rank's model
sharded before the window (shard_params_tp), its rows its dp index's.
An outcome: after each of the recipe's windows (dispatches) the window's
losses (this rank's), the parameters, their gradients at its last step
(after the all-reduce) and the BN running statistics, the sharded ones
gathered to their full shape; and the kernel launches, the dp group's
all-reduces and the tp group's collectives of the window's steps.

A recipe with sync_bn=False replays the per-replica step
(parallel/data_parallel.py) instead, one step at a time.

Serving over a group: `spawn_ranks(world, serve_endpoints, payload)` has
each rank serve a checkpoint through Sampler(dp=) of the default group and
call every endpoint (`endpoint_outputs`), whose answers the caller holds
against one device's.

A train CLI on the spawned ranks: `train_cli((module, argv), device)`
runs the CLI's main in each rank on the group the ranks already hold (the
CLI's parallel/distributed.py:maybe_initialize keeps it), "{rank}" in
argv replaced by the rank, and returns the rank's printed lines with the
host clock at each. `spawn_ranks(world, jobs, [(fn, payload), ...])` runs
several rank functions in turn on one set of ranks, so that they pay for
one start.
"""

import contextlib
import datetime
import importlib
import io
import multiprocessing
import os
import tempfile
import time

import torch
import torch.distributed as dist

from mvae_tpu_torch import ops
from mvae_tpu_torch.device import resolve_device
from mvae_tpu_torch.nn.norm import BatchNorm
from mvae_tpu_torch.parallel import tensor_parallel
from mvae_tpu_torch.parallel.collectives import all_reduce_sum
from mvae_tpu_torch.parallel.data_parallel import make_replica_train_step
from mvae_tpu_torch.parallel.distributed import choose_backend, rank_device
from mvae_tpu_torch.parallel.mesh import (
    DataParallel, data_parallel, gather_full, shard_params_tp)
from mvae_tpu_torch.serve import Sampler
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


def _full(model, tensors):
    """name -> tensor of the model's parameters, gathered to the full
    model's names and shapes where it is sharded."""
    layout = getattr(model, "tp_layout", None)
    if layout is None:
        return tensors
    return gather_full(layout, tensors, layout.params)


def _snapshot(model, losses):
    params = dict(model.named_parameters())
    return dict(
        losses=_copy(losses),
        params={n: _copy(p) for n, p in _full(model, params).items()},
        grads={n: _copy(p) for n, p in _full(
            model, {n: p.grad for n, p in params.items()}).items()},
        running={n: _copy(v) for n, v in model.state_dict().items()
                 if n.endswith(("running_mean", "running_var"))})


def replay(rc, device, dp=None) -> dict:
    """Run recipe rc on `device` as dp index dp.rank of dp (None: alone;
    with a model axis the model is sharded over dp's tp group):
    {"name", "windows": [a snapshot after each window: the window's
    losses (this rank's), the parameters, their gradients at its last
    step, the running statistics, its seconds to the end of its work],
    "n_bn", "launches", "all_reduces", "tp_collectives": the last three
    over the windows' steps alone, "collective_ms": collective_ms's
    reading after them}."""
    cls, args, kw = rc["model"]
    model = cls(*args, device=device, **kw)
    model.load_state_dict({n: v.to(device) for n, v in
                           rc["state_dict"].items()}, strict=True)
    if dp is not None and dp.tp_world > 1:
        shard_params_tp(model, dp)
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
    launches = dict.fromkeys(ops.launch_counts(), 0)
    calls = {"all_reduces": 0, "tp_collectives": 0}
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
        launches0, calls0 = ops.launch_counts(), (
            all_reduce_sum.calls, tensor_parallel.calls)
        t0 = time.perf_counter()
        losses = step(data, idxs[lo:hi], window(lo, hi, rc["betas"]),
                      noise=noise, **terms)
        _sync(device)
        seconds = time.perf_counter() - t0
        for k, v in ops.launch_counts().items():
            launches[k] += v - launches0[k]
        calls["all_reduces"] += all_reduce_sum.calls - calls0[0]
        calls["tp_collectives"] += tensor_parallel.calls - calls0[1]
        out.append(dict(_snapshot(model, losses), seconds=seconds))
        lo = hi
    cost = {} if dp is None else collective_ms(dp, device, (
        b, 2 * model.n_latents))
    return dict(name=rc["name"], windows=out, collective_ms=cost,
                n_bn=sum(isinstance(m, BatchNorm) for m in model.modules()),
                launches=launches, **calls)


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


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def collective_ms(dp, device, shape, reps=20) -> dict:
    """Host ms a call, to its end, of an all-reduce of an f32 `shape`
    tensor (a head's (rows, 2L) posterior) on the tp group where dp has
    one, and of a BN layer's (2, 1, 64) sums on the dp group: reps calls
    after one warm-up."""
    out = {}
    for name, group, t in (
            ("tp", dp.tp_group, torch.zeros(shape, device=device)),
            ("dp", dp.group, torch.zeros((2, 1, 64), device=device))):
        if group is None:
            continue
        dist.all_reduce(t, group=group)
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(reps):
            dist.all_reduce(t, group=group)
        _sync(device)
        out[name] = (time.perf_counter() - t0) * 1e3 / reps
    return out


def replay_all(recipes, device) -> list:
    """Every recipe replayed on this rank of the default group, the grid
    over the recipe's global batch: the rank function of
    spawn_ranks(world, replay_all, recipes), whose result outs[rank][i]
    is recipe i's outcome on that rank."""
    outs = []
    for rc in recipes:
        rows = len(next(iter(rc["data"].values()))) // len(rc["betas"])
        outs.append(replay(rc, device, data_parallel(rows)))
    return outs



def endpoint_outputs(sampler, inputs, conditions) -> dict:
    """Every endpoint of `sampler` on `inputs` (name -> a batch of rows):
    the prior sample (5 rows, seed 3), and for each modality set of
    `conditions` the sample conditioned on its first row (3 rows, seed
    4), embed and reconstruct; name -> output tensor, on the CPU."""
    out = {f"sample {k}": v for k, v in sampler.sample(n=5, seed=3).items()}
    for names in conditions:
        sub = {k: inputs[k] for k in names}
        tag = "+".join(names)
        got = sampler.sample(n=3, seed=4, condition={
            k: v[:1] for k, v in sub.items()})
        out.update({f"sample|{tag} {k}": v for k, v in got.items()})
        mu, logvar = sampler.embed(sub)
        out.update({f"embed|{tag} mu": mu, f"embed|{tag} logvar": logvar})
        got = sampler.reconstruct(sub)
        out.update({f"reconstruct|{tag} {k}": v for k, v in got.items()})
    return {k: v.detach().to("cpu", copy=True) for k, v in out.items()}


def serve_endpoints(payload, device) -> dict:
    """The rank function of serving over a group: payload["path"] served
    through Sampler(dp=) over the default group (compute dtype
    payload["dtype"]), endpoint_outputs of payload["inputs"] and
    payload["conditions"]."""
    dp = DataParallel(dist.group.WORLD, dist.get_rank(),
                      dist.get_world_size())
    sampler = Sampler.from_checkpoint(payload["path"], device=device,
                                      compute_dtype=payload["dtype"], dp=dp)
    return endpoint_outputs(sampler, {k: v.to(device) for k, v in
                                      payload["inputs"].items()},
                            payload["conditions"])


class TimedLines(io.TextIOBase):
    """A stdout that keeps each finished line with the host time it was
    finished at, and passes the text on to `sink` where one is given."""

    def __init__(self, sink=None):
        self.sink, self.part, self.lines = sink, "", []

    def write(self, text):
        if self.sink is not None:
            self.sink.write(text)
        *done, self.part = (self.part + text).split("\n")
        now = time.perf_counter()
        self.lines += [(now, line) for line in done]
        return len(text)

    def flush(self):
        if self.sink is not None:
            self.sink.flush()


def train_cli(payload, device) -> list:
    """The rank function of a train CLI on the spawned ranks (the module
    docstring): payload (module, argv); returns [(host time, line)] of
    what this rank printed."""
    module, argv = payload
    rank = str(dist.get_rank())
    out = TimedLines()
    with contextlib.redirect_stdout(out):
        importlib.import_module(module).main(
            [a.replace("{rank}", rank) for a in argv])
    return out.lines + ([(time.perf_counter(), out.part)] if out.part
                        else [])


def jobs(payload, device) -> list:
    """Several rank functions in turn on this rank: payload [(fn, its
    payload), ...]; returns their results in order."""
    return [fn(arg, device) for fn, arg in payload]
