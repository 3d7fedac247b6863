"""Rank functions of tests/test_torch_port_dp.py, run on spawned gloo ranks
through mvae_tpu_torch.tools.dp_check.spawn_ranks. This module imports no
JAX: a spawned rank imports it by name, without the test's conftest."""

import contextlib
import io
import os
import types

import torch
import torch.distributed as dist

from mvae_tpu_torch.core.engine import commit_ema_states
from mvae_tpu_torch.models import CelebaMVAE
from mvae_tpu_torch.nn.norm import (
    BatchNorm, bn_swish_from_moments, pop_moments, set_bn_sync, stacked_bn)
from mvae_tpu_torch.ops.bn import bn_swish_train
from mvae_tpu_torch.train.driver import run_training

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
