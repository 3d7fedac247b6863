"""Rank functions of tests/test_torch_port_dp.py and of the tensor-parallel
tests (tests/test_torch_port_tp_*.py), run on spawned gloo ranks through
mvae_tpu_torch.tools.dp_check.spawn_ranks. This module imports no JAX: a
spawned rank imports it by name, without the test's conftest."""

import contextlib
import io
import os
import types

import torch
import torch.distributed as dist

from mvae_tpu_torch.core.engine import commit_ema_states
from mvae_tpu_torch.models import CelebaMVAE, MnistMVAE
from mvae_tpu_torch.nn.dcgan import PosteriorHead
from mvae_tpu_torch.nn.norm import (
    BatchNorm, bn_swish_from_moments, pop_moments, set_bn_sync, stacked_bn)
from mvae_tpu_torch.ops.bn import bn_swish_train
from mvae_tpu_torch.parallel import tensor_parallel as tpl
from mvae_tpu_torch.parallel.mesh import data_parallel, shard_params_tp
from mvae_tpu_torch.train.checkpoint import (
    load_checkpoint, load_optimizer_state, model_state)
from mvae_tpu_torch.train.driver import run_training
from mvae_tpu_torch.train.loop import make_train_step

MASKS = [[1.0, 1.0], [1.0, 0.0], [0.0, 1.0]]
LAMBDAS = [[1.0, 10.0]] * 3


def group_rows(t, groups, rank, world):
    """Rank's rows of each of the `groups` consecutive blocks of t's rows."""
    g = t.reshape((groups, -1) + t.shape[1:])
    b = g.shape[1] // world
    return g[:, rank * b:(rank + 1) * b].reshape((-1,) + t.shape[1:])


def _bns(c, k, groups, scale, bias):
    bns = []
    for j in range(k):
        bn = BatchNorm(c, device="cpu")
        bn.reset_parameters()
        with torch.no_grad():
            bn.weight.copy_(scale[j * c:(j + 1) * c])
            bn.bias.copy_(bias[j * c:(j + 1) * c])
        bn.groups = groups
        bns.append(bn)
    return bns


def bn_case(case, rank, world, group):
    """One BN case on `rank`'s rows (world = 1, group None: the whole):
    y, mean, var (and the running statistics after a commit of the
    moments), dx, and the gradients of scale and bias."""
    kind, groups = case["kind"], case["groups"]
    x = group_rows(case["x"], groups, rank, world).clone().requires_grad_()
    g = group_rows(case["g"], groups, rank, world)
    scale, bias = case["scale"], case["bias"]
    out = {}
    if kind == "op":
        s, b = (scale.clone().requires_grad_(), bias.clone().requires_grad_())
        y, mean, var = bn_swish_train(x, s, b, groups, group)
        (y * g).sum().backward()
        out.update(mean=mean, var=var, dscale=s.grad, dbias=b.grad)
    elif kind in ("module", "stacked"):
        k = 2 if kind == "stacked" else 1
        bns = _bns(x.shape[1] // k, k, groups, scale, bias)
        holder = torch.nn.ModuleList(bns)
        set_bn_sync(holder, group)
        holder.train()
        y = stacked_bn(bns, x) if kind == "stacked" else bns[0](x)
        (y * g).sum().backward()
        moments = pop_moments(holder)
        out.update(mean=torch.cat([m.mean for m in moments], 1),
                   var=torch.cat([m.var for m in moments], 1),
                   n=torch.tensor([m.n for m in moments]),
                   dscale=torch.cat([bn.weight.grad for bn in bns]),
                   dbias=torch.cat([bn.bias.grad for bn in bns]))
        t = groups

        class Model:                  # the decoder's commit: G = T terms
            modality_index = staticmethod(lambda name: 0)

        commit_ema_states(Model(), {}, moments, torch.ones((t, 1)))
        out["running"] = torch.cat([torch.cat([bn.running_mean,
                                               bn.running_var])
                                    for bn in bns])
    else:                             # "moments": the fused route's BN
        bn = _bns(x.shape[1], 1, 1, scale, bias)[0]
        set_bn_sync(bn, group)
        xf = x.float()
        s, q = xf.sum(dim=(0, 2, 3)), (xf * xf).sum(dim=(0, 2, 3))
        y = bn_swish_from_moments(bn, x, s, q, x.dtype)
        (y * g).sum().backward()
        out.update(mean=bn.moments.mean, var=bn.moments.var,
                   n=torch.tensor([bn.moments.n]), dscale=bn.weight.grad,
                   dbias=bn.bias.grad)
    out.update(y=y.detach(), dx=x.grad)
    return {k: v.detach().clone() for k, v in out.items()}


def bn_cases(cases, device):
    """Every case on this rank of the default group."""
    rank, world = dist.get_rank(), dist.get_world_size()
    return [bn_case(c, rank, world, dist.group.WORLD) for c in cases]


def celeba_driver(payload, device):
    """run_training of CelebaMVAE(8) on this rank, B = 8, 2 epochs
    resident, into out/r{rank}: (its stdout, its state_dict)."""
    rank = dist.get_rank()
    args = types.SimpleNamespace(
        batch_size=8, log_interval=2, epochs=2, annealing_epochs=1, lr=1e-4,
        seed=3, resume=None, profile_dir=None, no_device_data=False)
    model = CelebaMVAE(8, device=device,
                       generator=torch.Generator().manual_seed(rank))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        run_training(model, payload["train"], payload["test"], args, MASKS,
                     LAMBDAS, out_dir=os.path.join(payload["out"],
                                                   f"r{rank}"),
                     meta={"model": "celeba", "n_latents": 8},
                     device=device)
    return buf.getvalue(), {k: v.detach().clone()
                            for k, v in model.state_dict().items()}


# --------------------------------------------------------------------------
# tensor parallelism
# --------------------------------------------------------------------------

class HeadModel(torch.nn.Module):
    """A posterior head as a model with one tp chain (its {fc, out})."""
    tp_experts = ()

    def __init__(self, d_in, n_latents, compute_dtype, seed):
        super().__init__()
        self.head = PosteriorHead(d_in, n_latents,
                                  compute_dtype=compute_dtype, device="cpu")
        gen = torch.Generator().manual_seed(seed)
        for lin in (self.head[0], self.head[3]):
            lin.reset_parameters(gen)

    def tp_chains(self):
        return [[("head.0",), ("head.3",)]]


def tp_ops(payload, device):
    """On this rank of a tp group of the default group's size:
    gather_from_tp's forward and its input's gradient under a loss that
    weighs the gathered features; a bf16 posterior head's eval-mode
    output, sharded (fc column, out row); and the collectives of each."""
    dp = data_parallel(1)                   # one row: every rank a tp rank
    rank, tp = dp.tp_rank, dp.tp_world
    x = payload["x"].chunk(tp, -1)[rank].clone().requires_grad_()
    calls0 = tpl.calls
    y = tpl.gather_from_tp(x, -1, dp.tp_group)
    (y * payload["w"]).sum().backward()
    out = dict(gathered=y.detach(), dx=x.grad, gather_calls=tpl.calls - calls0)
    head = HeadModel(*payload["head"])
    shard_params_tp(head, dp)
    head.eval()
    calls0 = tpl.calls
    with torch.no_grad():
        out["head"] = head.head(payload["h"])
    out["head_calls"] = tpl.calls - calls0
    return out


def tp_resume(payload, device):
    """A reference-layout checkpoint (model and Adam state) loaded into
    this rank's MnistMVAE(8) as the driver's resume does it: load, shard
    over the grid of batch payload["batch"], make the step, load the
    optimizer's state sliced. Returns the rank's parameters and moments
    by name, and the model_state gathered again."""
    ckpt = load_checkpoint(payload["path"], device="cpu")
    model = MnistMVAE(8, device="cpu")
    model.load_state_dict(ckpt["state_dict"], strict=True)
    dp = data_parallel(payload["batch"])
    shard_params_tp(model, dp)
    step = make_train_step(model, [[1.0, 1.0]], [[1.0, 1.0]], lr=1e-3,
                           generator=torch.Generator(), device="cpu", dp=dp)
    load_optimizer_state(model, step.optimizer, ckpt["optimizer"])
    names = [n for n, _ in model.named_parameters()]
    state = step.optimizer.state_dict()["state"]
    return dict(params={n: p.detach().clone()
                        for n, p in model.named_parameters()},
                exp_avg={names[i]: v["exp_avg"] for i, v in state.items()},
                exp_avg_sq={names[i]: v["exp_avg_sq"]
                            for i, v in state.items()},
                gathered=model_state(model))


def celeba_b100(payload, device):
    """run_training of CelebaMVAE(8) at B = 100 on this rank (3 ranks: dp1
    x tp3, 512 % 3 != 0: every parameter replicated), one epoch resident:
    (its stdout, its parameters' shapes, its state_dict)."""
    args = types.SimpleNamespace(
        batch_size=100, log_interval=1, epochs=1, annealing_epochs=1,
        lr=1e-4, seed=3, resume=None, profile_dir=None,
        no_device_data=False)
    model = CelebaMVAE(8, device=device)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        run_training(model, payload["train"], payload["test"], args, MASKS,
                     LAMBDAS, out_dir=os.path.join(
                         payload["out"], f"r{dist.get_rank()}"),
                     meta={"model": "celeba", "n_latents": 8},
                     device=device)
    return buf.getvalue(), {k: v.detach().clone()
                            for k, v in model.state_dict().items()}
