"""Vision MVAE training CLI of the port (counterpart of
experiments/vision/train.py): six image modalities, 7 ELBO terms a step,
the joint and one unimodal term a modality (vision/train.py:186-283).
Defaults as the JAX CLI's (vision/train.py:114-128): L=250, batch 50, 100
epochs, annealing 20, lr 1e-4, bf16 compute (--f32 for float32); every
term reconstructs all six modalities (RECON_MASKS), each BCE weighted 1/6;
the per-epoch eval runs the joint term alone.

    python -m mvae_tpu_torch.experiments.vision.train [--device cpu] ...

Trains on the CUDA card unless --device says otherwise, on the real
CelebA files under --data-dir or, without them, the synthetic set, the
modalities derived on the same device (data/vision.py); writes
checkpoint.pth.tar, model_best.pth.tar and a reconstruction grid a
epoch, reconstructions/epoch_{n}.png (6 rows, one a modality, of 8 test
images; vision/train.py:335-368), into --out-dir. --conv-moments takes
the encoders' fused conv + BN route; --stack-modalities runs each channel
group of three modalities as one stack (models/vision.py; the JAX
package's MVAE_STACK_MODALITIES=1), on the unfused route, so not with
--conv-moments; --no-device-data streams the batches from the host.
"""

import os

import numpy as np
import torch

from mvae_tpu_torch.data.vision import N_MODALITIES, load_celeb_vision
from mvae_tpu_torch.device import resolve_device
from mvae_tpu_torch.models.vision import MODALITIES, VisionMVAE
from mvae_tpu_torch.parallel.distributed import (
    is_coordinator, maybe_initialize)
from mvae_tpu_torch.train.driver import run_training
from mvae_tpu_torch.utils.cli import parse_train_args, train_parser
from mvae_tpu_torch.utils.png import save_image_grid

# the joint term and one unimodal term a modality: the posterior masks
# pick each term's experts; every term reconstructs all six modalities
# (vision/train.py:227-283), each BCE weighted 1/6 (:57)
TERM_MASKS = np.concatenate([np.ones((1, 6), np.float32),
                             np.eye(6, dtype=np.float32)])
RECON_MASKS = np.ones((7, 6), np.float32)
TERM_LAMBDAS = np.full((7, 6), 1.0 / N_MODALITIES, np.float32)
# the eval computes the joint term alone (vision/train.py:324-332)
EVAL_MASKS = np.ones((1, 6), np.float32)
EVAL_LAMBDAS = np.full((1, 6), 1.0 / N_MODALITIES, np.float32)


def recon_dump(test_ds, out_dir, device):
    """The driver's post_epoch hook: reconstructions/epoch_{n}.png, the
    sigmoid reconstructions of every modality from the joint posterior
    mean of the first 8 test rows, one row of 8 a modality (the
    one-channel modalities repeated to RGB)."""
    batch = {k: torch.from_numpy(v[:8]).to(device)
             for k, v in test_ds.arrays.items()}

    def hook(epoch, model):
        with torch.inference_mode():
            mu, _ = model.infer(batch)
            recons, _ = model.decode(mu)
        if not is_coordinator():        # every rank computes, rank 0 writes
            return
        rows = []
        for m in MODALITIES:
            img = torch.sigmoid(recons[m].float()).cpu().numpy()
            rows.append(np.repeat(img, 3, axis=-1) if img.shape[-1] == 1
                        else img)
        d = os.path.join(out_dir, "reconstructions")
        os.makedirs(d, exist_ok=True)
        save_image_grid(os.path.join(d, f"epoch_{epoch}.png"),
                        np.concatenate(rows), nrow=8)
    return hook


def parser():
    p = train_parser(n_latents=250, epochs=100, annealing_epochs=20,
                     lr=1e-4, batch_size=50, lambda_flags=(),
                     bf16_default=True)
    p.add_argument('--conv-moments', action='store_true',
                   help='run the encoders\' BN\'d convs fused, through the '
                        'conv2d_moments kernel, instead of a conv and then '
                        'the BN kernels')
    p.add_argument('--stack-modalities', action='store_true',
                   help='run each group of three modalities of one channel '
                        'count as one conv stack (grouped convolutions; '
                        'the unfused route: not with --conv-moments)')
    return p


def main(argv=None):
    args = parse_train_args(parser(), argv)
    maybe_initialize(args)         # a rank's process group and card
    device = resolve_device(args.device)
    if not args.bf16:
        # --f32 promises the reference numerics: no TF32 in cuDNN's convs
        torch.backends.cudnn.allow_tf32 = False
    model = VisionMVAE(args.n_latents,
                       torch.bfloat16 if args.bf16 else None,
                       conv_moments=args.conv_moments,
                       stack_modalities=args.stack_modalities, device=device,
                       generator=torch.Generator().manual_seed(args.seed))
    train_ds = load_celeb_vision(args.data_dir, 'train',
                                 download=args.download, device=device,
                                 exact_decode=args.exact_decode)
    test_ds = load_celeb_vision(args.data_dir, 'val', device=device,
                                exact_decode=args.exact_decode)
    return run_training(
        model, train_ds, test_ds, args, TERM_MASKS, TERM_LAMBDAS,
        out_dir=args.out_dir, device=device,
        meta={"model": "vision", "n_latents": args.n_latents},
        recon_masks=RECON_MASKS, eval_term_masks=EVAL_MASKS,
        eval_term_lambdas=EVAL_LAMBDAS,
        post_epoch=recon_dump(test_ds, args.out_dir, device))


if __name__ == "__main__":
    main()
