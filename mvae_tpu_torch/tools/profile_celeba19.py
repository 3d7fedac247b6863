"""celeba19's train step by stage, in f32 and bf16 (counterpart of
scripts/profile_celeba19.py).

    python -m mvae_tpu_torch.tools.profile_celeba19 [--batch 100] [--k 50]
        [--n-latents 100] [--seed 0] [--device cpu]

Celeba19MVAE(L) in float32 (TF32 off, as the CLI's --f32), then in bf16
with the image BCE's bf16 math (the CLI's default under bf16), weights
from --seed; one batch of B rows from np.random.default_rng(0) as the JAX
script draws it (float images in [0, 1], attributes 0/1); the T = 21
terms of core/subsets.py:celeba19_step_terms(default_rng(1), 1, 18, 1,
10) and the CLI's recon support, celeba19_recon_support(1). The stages,
each on the port's own functions:

  encode                  the 19 experts once, train mode
                          (models/celeba19.py:encode)
  fuse+reparam            ops/poe.py:masked_poe_all_terms over the T
                          masks, then z = mu + eps exp(lv / 2)
  decode all T            every term through every decoder, the one
                          batch (model.decode(z, groups=T))
  decode grouped+gather   core/engine.py:_decode_grouped under the
                          support's decode_plan, the gathered experts
                          and the groups' losses included
  full forward            core/engine.py:multi_term_elbo, train mode,
                          beta 0.5
  forward+backward        the same and its backward
  full step               train/loop.py:make_multi_train_step over 1000
                          uint8 rows resident on the device, K steps a
                          call, masks and lambdas a step

The first five run without autograd, as the JAX script's forwards do.
Each stage call feeds a scalar of its output into a carry that the next
call takes in (the JAX script's scan carry), and is timed as the JAX
script times it: K calls, then the host reads the carry (a hard fence);
wall ms a call over REPS repetitions after one warm-up. On the card a
profiled window of K more calls gives each stage's device ms, launches
and idle share a call, cuDNN's layout transforms' us and launches a call
(the family "layout transform (cuDNN)"), and the kernel records the
profiler lost (tools/measure.py:profile_breakdown).

Prints one JSON line a precision. Runs on the CUDA card unless --device
says otherwise; on the CPU every device metric is null.
"""

import argparse
import contextlib
import json
import time

import numpy as np
import torch

from mvae_tpu_torch.core.engine import (
    _decode_grouped, decode_plan, multi_term_elbo)
from mvae_tpu_torch.core.sampling import reparametrize
from mvae_tpu_torch.core.subsets import (
    celeba19_recon_support, celeba19_step_terms)
from mvae_tpu_torch.device import resolve_device
from mvae_tpu_torch.models.celeba19 import N_ATTRS, Celeba19MVAE
from mvae_tpu_torch.ops.poe import masked_poe_all_terms
from mvae_tpu_torch.tools import measure
from mvae_tpu_torch.tools.bench import no_tf32
from mvae_tpu_torch.train.loop import draw_noise, make_multi_train_step

N_ROWS = 1000           # the full step's resident rows (the JAX script's)
REPS = 3                # timed repetitions of K calls, after one warm-up
LR = 1e-4
BETA = 0.5
LAMBDAS = (1.0, 10.0)   # the CLI's lambda image and attrs
STAGES = ("encode", "fuse+reparam", "decode all T", "decode grouped+gather",
          "full forward", "forward+backward", "full step")


def encode(model, inputs, keep_mask=None):
    """The 19 posteriors (M, B, L): mu, logvar."""
    mu, logvar, _ = model.encode(inputs, keep_mask)
    return mu, logvar


def fuse(mu, logvar, masks, eps=None):
    """The T fused posteriors and their sample z (z = mu without eps)."""
    pd_mu, pd_logvar = masked_poe_all_terms(mu, logvar, masks)
    return pd_mu, pd_logvar, reparametrize(pd_mu, pd_logvar, eps)


def decode_all(model, z):
    """Every term's z (T, B, L) through every decoder as one batch."""
    t, b, d = z.shape
    recons, _ = model.decode(z.reshape(t * b, d), groups=t)
    return recons


def decode_grouped(model, z, plan, inputs):
    """The grouped decode's (T, B, M) loss stack (core/engine.py)."""
    stack, _ = _decode_grouped(model, z, plan, inputs, None)
    return stack


def forward(model, inputs, masks, lambdas, noise, plan, beta=BETA):
    """The train-mode multi-term ELBO's total."""
    total, _ = multi_term_elbo(model, inputs, masks, lambdas, beta,
                               train=True, noise=noise, plan=plan)
    return total


class Setup:
    """One precision's model, batch, terms, plan and generator (the module
    docstring)."""

    def __init__(self, compute_dtype, n_latents, inputs, host, device, seed):
        self.device = device
        bf16 = compute_dtype == torch.bfloat16
        self.model = Celeba19MVAE(
            n_latents, compute_dtype, bf16_loss=bf16, device=device,
            generator=torch.Generator().manual_seed(seed))
        self.inputs = {k: torch.as_tensor(v, device=device)
                       for k, v in inputs.items()}
        masks, lambdas = celeba19_step_terms(np.random.default_rng(1), 1,
                                             N_ATTRS, *LAMBDAS)
        self.masks = torch.as_tensor(masks, device=device)
        self.lambdas = torch.as_tensor(lambdas, device=device)
        self.support = celeba19_recon_support(1, N_ATTRS)
        self.plan = decode_plan(self.model, self.support, device=device)
        self.gen = torch.Generator(device=device).manual_seed(seed + 1)
        self.host = host
        self.batch = inputs["image"].shape[0]

    def noise(self):
        return draw_noise(self.model, self.masks.shape[0], self.batch,
                          self.gen)

    def stages(self):
        """(name, call) of the first six stages: call(carry) -> carry."""
        m, x, masks = self.model, self.inputs, self.masks
        t, b, d = masks.shape[0], self.batch, m.n_latents
        m.train()
        with torch.no_grad():
            mu0, lv0 = encode(m, x, self.noise()[1])
        z0 = torch.zeros((t, b, d), device=self.device)

        def enc(c):
            mu, lv = encode(m, x, self.noise()[1])
            return c + mu[0, 0].sum() + lv[0, 0].sum()

        def fus(c):
            eps = torch.randn((t, b, d), generator=self.gen,
                              device=self.device)
            return c + fuse(mu0 + c * 0, lv0, masks, eps)[2][0, 0].sum()

        def dec(c):
            r = decode_all(m, z0 + c * 0)
            return c + r["image"][0, 0].sum() + r["attrs"][0].sum()

        def grouped(c):
            return c + decode_grouped(m, z0 + c * 0, self.plan, x)[0, 0].sum()

        def fwd(c):
            return c + forward(m, x, masks, self.lambdas, self.noise(),
                               self.plan, BETA + c * 0)

        def fwdbwd(c):
            m.zero_grad(set_to_none=True)
            with torch.enable_grad():
                total = forward(m, x, masks, self.lambdas, self.noise(),
                                self.plan)
                (total + c * 0).backward()
            return c + total.detach()

        return list(zip(STAGES[:6], (enc, fus, dec, grouped, fwd, fwdbwd)))

    def full_step(self, k):
        """The full step's window of k steps: () -> (k,) losses."""
        multi = make_multi_train_step(self.model, None, None, lr=LR,
                                      generator=self.gen,
                                      device=self.device,
                                      recon_support=self.support)
        host = self.host
        data = {"image": torch.from_numpy(
                    (host.random((N_ROWS, 64, 64, 3)) * 255).astype(np.uint8)
                ).to(self.device),
                "attrs": torch.from_numpy(
                    (host.random((N_ROWS, N_ATTRS)) < 0.3).astype(np.float32)
                ).to(self.device)}
        idxs = torch.from_numpy(host.integers(0, N_ROWS, (k, self.batch))
                                ).to(self.device)
        betas = torch.full((k,), BETA, device=self.device)
        masks = self.masks.expand((k,) + self.masks.shape).contiguous()
        lambdas = self.lambdas.expand((k,) + self.lambdas.shape).contiguous()
        return lambda: multi(data, idxs, betas, masks=masks, lambdas=lambdas)


def carried(call, k, device):
    """() -> the carry after k calls of call from 0 (one K-call window)."""
    def window():
        c = torch.zeros((), device=device)
        with torch.no_grad():
            for _ in range(k):
                c = call(c)
        return c
    return window


def wall_ms(window, k):
    """ms a call: one warm-up window, then REPS windows of k calls, each
    fenced by the host reading its last value."""
    float(window().reshape(-1)[-1])
    t0 = time.perf_counter()
    for _ in range(REPS):
        float(window().reshape(-1)[-1])
    return (time.perf_counter() - t0) / (REPS * k) * 1e3


def profile(setup, k, tag, card):
    """One precision's stage rows."""
    device = setup.device
    windows = [(name, carried(call, k, device))
               for name, call in setup.stages()]
    windows.append((STAGES[6], setup.full_step(k)))
    rows = []
    for name, window in windows:
        ms = wall_ms(window, k)
        row = {"stage": name, "wall_ms": ms, "device_ms": None,
               "launches": None, "idle_share": None, "records_lost": None,
               "layout_transform_us": None,
               "layout_transform_launches": None}
        if measure.on_card(device):
            prof = measure.profile_breakdown(
                f"profile_celeba19 {tag} {name}, a window of {k}", window,
                card, reps=1, per=k, wall_ms=ms)
            moved = [r for r in prof["kernels"] if r[3] == measure.LAYOUT]
            row.update(device_ms=prof["device_ms"],
                       launches=prof["launches"],
                       idle_share=prof["idle_share"],
                       records_lost=prof["records_lost"],
                       layout_transform_us=1e3 * sum(r[1] for r in moved),
                       layout_transform_launches=sum(r[2] for r in moved))
        rows.append(row)
    return rows


def parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=100)
    ap.add_argument("--k", type=int, default=50)
    ap.add_argument("--n-latents", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", type=str, default=None,
                    help="default: the CUDA card; 'cpu' for a rehearsal "
                         "(its numbers are not the card's)")
    return ap


def main(argv=None):
    """Prints one JSON line a precision; returns them."""
    args = parser().parse_args(argv)
    device = resolve_device(args.device)
    line = measure.device_line(device)
    host = np.random.default_rng(0)
    inputs = {"image": host.random((args.batch, 64, 64, 3)).astype(
                  np.float32),
              "attrs": (host.random((args.batch, N_ATTRS)) < 0.3).astype(
                  np.float32)}
    out = []
    for tag, dtype in (("f32", None), ("bf16", torch.bfloat16)):
        with no_tf32() if dtype is None else contextlib.nullcontext():
            setup = Setup(dtype, args.n_latents, inputs, host, device,
                          args.seed)
            rows = profile(setup, args.k, tag, measure.card_text(line))
        rec = {"precision": tag, "batch": args.batch, "k": args.k,
               "n_latents": args.n_latents, "terms": int(setup.masks.shape[0]),
               "stages": rows, "full_step_steps_per_sec":
                   1e3 / rows[-1]["wall_ms"], "device": line,
               "seed": args.seed}
        print(json.dumps(rec), flush=True)
        out.append(rec)
    return out


if __name__ == "__main__":
    main()
