"""Eval step and input decode (counterpart of mvae_tpu/train/loop.py:16-51,
239-262)."""

import torch

from mvae_tpu_torch.core.engine import multi_term_elbo
from mvae_tpu_torch.device import resolve_device


def decode_batch(batch, dtype=torch.float32):
    """uint8 image tensors become `dtype` in [0, 1]; other dtypes pass
    through. In bf16 the quotient rounds once to bf16, as
    `v.astype(bf16) / bf16(255)` does in the JAX package."""
    return {k: (v.to(dtype) / 255 if v.dtype == torch.uint8 else v)
            for k, v in batch.items()}


def resolve_decode_dtype(model, decode_dtype=None):
    """The input-decode dtype: `decode_dtype` if given, else bf16 when the
    model computes in bf16 and f32 otherwise (train/loop.py:32-51)."""
    if decode_dtype is not None:
        return decode_dtype
    if getattr(model, "compute_dtype", None) == torch.bfloat16:
        return torch.bfloat16
    return torch.float32


def make_eval_step(model, term_masks, term_lambdas, *, device=None,
                   device_data: bool = False, decode_dtype=None):
    """Eval: beta = 1, z = mu, running BN statistics, no dropout (reference
    test(): mnist/train.py:229-253).

    device: None runs on the CUDA card (raises without one), "cpu" on the
    CPU; the model must already live there.
    device_data=True: the step takes (data, idx) with `data` the whole
    dataset on the device and idx the (B,) batch rows; the gather runs on
    the device.

    Step signature: eval_step(batch) -> (total, per_term (T,)).
    """
    device = resolve_device(device)
    if model.device != device:
        raise ValueError(f"the model lives on {model.device}, the eval step "
                         f"was asked to run on {device}")
    masks = torch.as_tensor(term_masks, dtype=torch.float32, device=device)
    lambdas = torch.as_tensor(term_lambdas, dtype=torch.float32,
                              device=device)
    decode_dt = resolve_decode_dtype(model, decode_dtype)

    @torch.inference_mode()
    def eval_step(batch):
        if device_data:
            data, idx = batch
            batch = {k: v.index_select(0, idx) for k, v in data.items()}
        batch = decode_batch(batch, decode_dt)
        total, aux = multi_term_elbo(model, batch, masks, lambdas, 1.0,
                                     train=False)
        return total, aux["per_term"]

    return eval_step
