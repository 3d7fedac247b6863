"""Resumable checkpoints in the reference's `.pth.tar` layout, with its
dual-file contract (counterpart of mvae_tpu/train/checkpoint.py, which
writes msgpack; the reference: mnist/train.py:115-129).

The file is `torch.save` of

    {"state_dict": the model's reference-layout state_dict,
     "best_loss", "n_latents", "optimizer": the optimizer's state_dict,
     "epoch", "generator": the noise generator's state, "model": the
     family ("mnist", "fashionmnist", "celeba", "multimnist",
     "celeba19", "vision"), "test_loss", and for celeba19 "mask_rng":
     the state of the numpy Generator of its sampled terms}

written atomically to `checkpoint.pth.tar` and copied to
`model_best.pth.tar` when the test loss improves. It holds everything a
bitwise resume needs and loads with `torch.load(weights_only=True)`, so
Sampler.from_checkpoint serves it, train/driver.py:load_model_checkpoint
rebuilds its model, and the JAX package reads it through
mvae_tpu/utils/torch_import.py as it reads the reference's own files.

Under tensor and expert parallelism (a model sharded by parallel/mesh.py:
shard_params_tp) the file is the same: `model_state` and
`optimizer_state` gather the sharded parameters and Adam's exp_avg and
exp_avg_sq for them over the tp group, the optimizer's state indexed by
the full model's parameters, so the file loads on one device; every rank
of the tp group calls them. `load_optimizer_state` slices a full
optimizer state (a one-device run's or a grid's) for a sharded model.
"""

import os
import shutil
import tempfile

import torch

from mvae_tpu_torch.parallel.mesh import gather_full, local_from_full

MOMENTS = ("exp_avg", "exp_avg_sq")

CKPT = "checkpoint.pth.tar"
BEST = "model_best.pth.tar"


def save_checkpoint(payload: dict, is_best: bool, folder: str):
    """Write payload to folder/checkpoint.pth.tar through a temporary file
    and an atomic rename; copy it to folder/model_best.pth.tar if
    is_best."""
    os.makedirs(folder, exist_ok=True)
    path = os.path.join(folder, CKPT)
    fd, tmp = tempfile.mkstemp(dir=folder, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            torch.save(payload, f)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    if is_best:
        shutil.copyfile(path, os.path.join(folder, BEST))


def load_checkpoint(path: str, *, device) -> dict:
    """The payload of a `.pth.tar`, tensors on `device` (the generator's
    state stays on the CPU, where torch keeps it)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    ckpt["state_dict"] = {k: v.to(device)
                          for k, v in ckpt.get("state_dict", ckpt).items()}
    return ckpt


def model_state(model) -> dict:
    """The model's state_dict in the reference layout: gathered over the
    tp group where the model is sharded."""
    layout = getattr(model, "tp_layout", None)
    sd = model.state_dict()
    return sd if layout is None else gather_full(layout, sd)


def _full_groups(groups, n):
    return [dict(g, params=list(range(n))) for g in groups]


def optimizer_state(model, optimizer) -> dict:
    """optimizer.state_dict() (Adam's) in the reference layout: where the
    model is sharded, the moments gathered over the tp group and indexed
    by the full model's parameter order."""
    sd = optimizer.state_dict()
    layout = getattr(model, "tp_layout", None)
    if layout is None:
        return sd
    names = [n for n, _ in model.named_parameters()]
    by_name = {names[i]: v for i, v in sd["state"].items()}
    state = {}
    if by_name:
        step = next(iter(by_name.values()))["step"]
        full = {k: gather_full(layout, {n: v[k] for n, v in by_name.items()},
                               layout.params) for k in MOMENTS}
        state = {i: dict(step=step, **{k: full[k][n] for k in MOMENTS})
                 for i, n in enumerate(layout.params)}
    return {"state": state,
            "param_groups": _full_groups(sd["param_groups"],
                                         len(layout.params))}


def load_optimizer_state(model, optimizer, full: dict):
    """Load a reference-layout optimizer state (optimizer_state's, or a
    one-device run's) into the optimizer of `model`: sliced to the rank's
    parameters where the model is sharded."""
    layout = getattr(model, "tp_layout", None)
    if layout is None:
        optimizer.load_state_dict(full)
        return
    by_name = {layout.params[i]: v for i, v in full["state"].items()}
    local = {k: local_from_full(layout, {n: v[k] for n, v in
                                         by_name.items()}) for k in MOMENTS}
    names = [n for n, _ in model.named_parameters()]
    state = {i: dict(by_name[n], **{k: local[k][n].clone() for k in MOMENTS})
             for i, n in enumerate(names) if n in by_name}
    optimizer.load_state_dict({
        "state": state,
        "param_groups": _full_groups(full["param_groups"], len(names))})
