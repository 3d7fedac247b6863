"""Resumable checkpoints in the reference's `.pth.tar` layout, with its
dual-file contract (counterpart of mvae_tpu/train/checkpoint.py, which
writes msgpack; the reference: mnist/train.py:115-129).

The file is `torch.save` of

    {"state_dict": the model's reference-layout state_dict,
     "best_loss", "n_latents", "optimizer": the optimizer's state_dict,
     "epoch", "generator": the noise generator's state, "model": the
     family ("mnist", "fashionmnist", "celeba"), "test_loss"}

written atomically to `checkpoint.pth.tar` and copied to
`model_best.pth.tar` when the test loss improves. It holds everything a
bitwise resume needs and loads with `torch.load(weights_only=True)`, so
Sampler.from_checkpoint serves it, train/driver.py:load_model_checkpoint
rebuilds its model, and the JAX package reads it through
mvae_tpu/utils/torch_import.py as it reads the reference's own files.
"""

import os
import shutil
import tempfile

import torch

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
