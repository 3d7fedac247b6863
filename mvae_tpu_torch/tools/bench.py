"""CelebA training steps/s on the card against the paper's reference flow
timed in turns on the same card (counterpart of bench.py).

    python -m mvae_tpu_torch.tools.bench [--k 100] [--windows 5]
        [--warmup 2] [--seed 0] [--device cpu]

Ours (Ours, measure_ours): the port's main path, train/loop.py:
make_multi_train_step over CelebaMVAE(100) in bf16, B = 100, the masks
[[1, 1], [1, 0], [0, 1]], Adam(1e-4), betas of 0.5, on 2000 uint8 rows
resident on the card, random from --seed. The terms are weighted as the
CelebA train CLI weights them (image 1, attrs 10,
experiments/celeba/train.py); bench.py weights image 10, attrs 1. The
line says which.

The reference flow (ReferenceFlow, measure_reference_flow): the port's
own copy of bench.py's PyTorch model and step, three eager forwards a
step (joint, image only, attrs only), each decoding both modalities, in
float32 with TF32 off as the reference ran; a timing yardstick only, its loss is not the port's.
It runs on the same card, in turns with ours: reference, ours, ours,
reference, each turn --windows windows of --k steps after --warmup
warm-up windows of each. Every window ends with the host reading its
last loss. No number is read from or written to a file.

Then one more window of ours under torch.profiler (tools/measure.py:
profile_breakdown), apart from the timed ones: device ms, launches and
the idle share a step against the timed windows' median, device ms by
kernel family; the FLOPs a step counted from shapes (measure.
flops_per_step), the TFLOP/s sustained and mfu; the peak memory of a
window.

The last line is one JSON object, as bench.py prints: metric, value
(steps/s, the median over ours' windows), unit, vs_baseline (value over
the reference flow's median), windows (count, steps, median, min, max),
baseline_steps_per_sec, tflops_sustained, flops_per_step, mfu,
idle_share, device_ms_per_step, launches_per_step, peak_mem_bytes,
device (name, power limit, count), seed. Runs on the CUDA card unless
--device says otherwise; on the CPU device is "cpu" and every device
metric null.
"""

import argparse
import contextlib
import json

import numpy as np
import torch
import torch.nn as nn

from mvae_tpu_torch.device import resolve_device
from mvae_tpu_torch.models.celeba import N_ATTRS, CelebaMVAE
from mvae_tpu_torch.tools import measure
from mvae_tpu_torch.train.loop import make_multi_train_step

BATCH = 100
N_LATENTS = 100
N_ROWS = 2000
MASKS = [[1.0, 1.0], [1.0, 0.0], [0.0, 1.0]]
LAMBDAS = [[1.0, 10.0]] * 3     # the CLI's; bench.py:52-53 has [[10, 1]]
LR = 1e-4
BETA = 0.5
TURNS = ("reference", "ours", "ours", "reference")


class Ours:
    """The main path: the model, its K-step window and the resident data."""

    def __init__(self, device, seed, k):
        self.device, self.k = device, k
        self.model = CelebaMVAE(N_LATENTS, torch.bfloat16, device=device,
                                generator=torch.Generator().manual_seed(seed))
        self.multi = make_multi_train_step(
            self.model, MASKS, LAMBDAS, lr=LR, device=device,
            generator=torch.Generator(device=device).manual_seed(seed))
        host = np.random.default_rng(seed)
        self.data = {
            "image": torch.from_numpy((host.random((N_ROWS, 64, 64, 3))
                                       * 255).astype(np.uint8)).to(device),
            "attrs": torch.from_numpy((host.random((N_ROWS, N_ATTRS)) < 0.3)
                                      .astype(np.float32)).to(device)}
        self.betas = torch.full((k,), BETA, device=device)
        self.seed, self.count = seed, 0

    def window(self):
        """Returns a callable running one window of k steps on fresh rows
        (drawn before it is timed)."""
        rng = np.random.default_rng((self.seed, self.count))
        self.count += 1
        idxs = torch.from_numpy(rng.integers(0, N_ROWS, (self.k, BATCH))
                                ).to(self.device)
        return lambda: self.multi(self.data, idxs, self.betas)


class Swish(nn.Module):
    def forward(self, x):
        return x * torch.sigmoid(x)


class ReferenceModel(nn.Module):
    """bench.py:123-185: the reference's CelebA MVAE in stock PyTorch
    modules (nn.Conv2d, nn.BatchNorm2d, ...), one PoE over the given
    modalities and the prior."""

    def __init__(self, n_latents, n_attrs=N_ATTRS):
        super().__init__()
        L, A = n_latents, n_attrs
        self.n_latents = L
        self.enc = nn.Sequential(
            nn.Conv2d(3, 32, 4, 2, 1, bias=False), Swish(),
            nn.Conv2d(32, 64, 4, 2, 1, bias=False), nn.BatchNorm2d(64),
            Swish(),
            nn.Conv2d(64, 128, 4, 2, 1, bias=False), nn.BatchNorm2d(128),
            Swish(),
            nn.Conv2d(128, 256, 4, 1, 0, bias=False), nn.BatchNorm2d(256),
            Swish())
        self.enc_head = nn.Sequential(
            nn.Linear(256 * 5 * 5, 512), Swish(), nn.Dropout(0.1),
            nn.Linear(512, 2 * L))
        self.dec_up = nn.Sequential(nn.Linear(L, 256 * 5 * 5), Swish())
        self.dec = nn.Sequential(
            nn.ConvTranspose2d(256, 128, 4, 1, 0, bias=False),
            nn.BatchNorm2d(128), Swish(),
            nn.ConvTranspose2d(128, 64, 4, 2, 1, bias=False),
            nn.BatchNorm2d(64), Swish(),
            nn.ConvTranspose2d(64, 32, 4, 2, 1, bias=False),
            nn.BatchNorm2d(32), Swish(),
            nn.ConvTranspose2d(32, 3, 4, 2, 1, bias=False))
        self.attr_enc = nn.Sequential(
            nn.Linear(A, 512), nn.BatchNorm1d(512), Swish(),
            nn.Linear(512, 512), nn.BatchNorm1d(512), Swish(),
            nn.Linear(512, 2 * L))
        self.attr_dec = nn.Sequential(
            nn.Linear(L, 512), nn.BatchNorm1d(512), Swish(),
            nn.Linear(512, 512), nn.BatchNorm1d(512), Swish(),
            nn.Linear(512, 512), nn.BatchNorm1d(512), Swish(),
            nn.Linear(512, A))

    def infer(self, image=None, attrs=None):
        x = image if image is not None else attrs
        b, L = x.shape[0], self.n_latents
        mus = [x.new_zeros(b, L)]
        lvs = [x.new_zeros(b, L)]
        if image is not None:
            h = self.enc_head(self.enc(image).flatten(1))
            mus.append(h[:, :L])
            lvs.append(h[:, L:])
        if attrs is not None:
            h = self.attr_enc(attrs)
            mus.append(h[:, :L])
            lvs.append(h[:, L:])
        mu, lv = torch.stack(mus), torch.stack(lvs)
        t = 1.0 / (lv.exp() + 1e-8)
        return (mu * t).sum(0) / t.sum(0), torch.log(1.0 / t.sum(0))

    def forward(self, image=None, attrs=None):
        mu, lv = self.infer(image, attrs)
        z = mu + torch.randn_like(mu) * (0.5 * lv).exp()
        img = self.dec(self.dec_up(z).view(-1, 256, 5, 5))
        return img, self.attr_dec(z), mu, lv


def _bce(x, t):
    return x.clamp(min=0) - x * t + torch.log1p((-x.abs()).exp())


def reference_elbo(img_r, img, att_r, att, mu, lv, beta=BETA):
    """bench.py:190-197: the KL times beta, the image BCE and ten times
    the attributes' (the CLI's weights)."""
    loss = -0.5 * (1 + lv - mu ** 2 - lv.exp()).sum(1) * beta
    if img_r is not None:
        loss = loss + _bce(img_r.flatten(1), img.flatten(1)).sum(1)
    if att_r is not None:
        loss = loss + 10.0 * _bce(att_r, att).sum(1)
    return loss.mean()


@contextlib.contextmanager
def no_tf32():
    """float32 as the reference ran it: no TF32 in cuDNN or cuBLAS;
    restored after."""
    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = old


class ReferenceFlow:
    """bench.py:measure_torch_baseline's step on `device`: Adam(1e-4), one
    fixed batch of B rows from seed, three forwards a step (joint, image
    only, attrs only) and one backward of their summed ELBOs."""

    def __init__(self, device, seed, k):
        self.k = k
        torch.manual_seed(seed)
        self.model = ReferenceModel(N_LATENTS).to(device).train()
        self.opt = torch.optim.Adam(self.model.parameters(), lr=LR)
        gen = torch.Generator(device=device).manual_seed(seed)
        self.image = torch.rand((BATCH, 3, 64, 64), generator=gen,
                                device=device)
        self.attrs = (torch.rand((BATCH, N_ATTRS), generator=gen,
                                 device=device) < 0.3).float()

    def step(self):
        m, image, attrs = self.model, self.image, self.attrs
        self.opt.zero_grad()
        a = m(image, attrs)
        b = m(image, None)
        c = m(None, attrs)
        loss = (reference_elbo(a[0], image, a[1], attrs, a[2], a[3])
                + reference_elbo(b[0], image, None, None, b[2], b[3])
                + reference_elbo(None, None, c[1], attrs, c[2], c[3]))
        loss.backward()
        self.opt.step()
        return loss.detach()

    def window(self):
        return lambda: torch.stack([self.step() for _ in range(self.k)])


def measure_ours(ours, windows):
    """steps/s of `windows` windows of the main path."""
    return [ours.k / measure.window_seconds(ours.window())
            for _ in range(windows)]


def measure_reference_flow(reference, windows):
    """steps/s of `windows` windows of the reference flow, TF32 off."""
    with no_tf32():
        return [reference.k / measure.window_seconds(reference.window())
                for _ in range(windows)]


def measure_turns(ours, reference, windows, warmup):
    """steps/s of every timed window of each, in TURNS after `warmup`
    windows of each."""
    measure_ours(ours, warmup)
    measure_reference_flow(reference, warmup)
    rates = {"ours": [], "reference": []}
    for turn in TURNS:
        run = measure_ours if turn == "ours" else measure_reference_flow
        rates[turn] += run(ours if turn == "ours" else reference, windows)
    return rates


def parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--k", type=int, default=100,
                    help="steps a window")
    ap.add_argument("--windows", type=int, default=5,
                    help="timed windows a turn")
    ap.add_argument("--warmup", type=int, default=2,
                    help="warm-up windows of each side")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", type=str, default=None,
                    help="default: the CUDA card; 'cpu' for a rehearsal "
                         "(its numbers are not the card's)")
    return ap


def main(argv=None):
    """Prints the JSON line; returns it."""
    args = parser().parse_args(argv)
    device = resolve_device(args.device)
    line = measure.device_line(device)
    on_card = measure.on_card(device)
    ours = Ours(device, args.seed, args.k)
    reference = ReferenceFlow(device, args.seed, args.k)
    rates = measure_turns(ours, reference, args.windows, args.warmup)
    value = measure.spread(rates["ours"])["median"]
    baseline = measure.spread(rates["reference"])["median"]
    flops = measure.flops_per_step(ours.model, MASKS, LAMBDAS, BATCH)
    out = {"metric": "celeba_train_steps_per_sec", "value": value,
           "unit": (f"steps/s (CelebaMVAE({N_LATENTS}) bf16, batch "
                    f"{BATCH}, 3 ELBO terms weighted image 1, attrs 10 as "
                    f"the CelebA train CLI; bench.py weights image 10, "
                    f"attrs 1)"),
           "vs_baseline": value / baseline,
           "windows": {"steps": args.k, **measure.spread(rates["ours"])},
           "baseline_steps_per_sec": baseline,
           "baseline_windows": {"steps": args.k,
                                **measure.spread(rates["reference"])},
           "lambdas": LAMBDAS[0], "flops_per_step": flops,
           "tflops_sustained": None, "mfu": None, "idle_share": None,
           "device_ms_per_step": None, "launches_per_step": None,
           "peak_mem_bytes": None, "device": line, "seed": args.seed}
    if on_card:
        prof = measure.profile_breakdown(
            f"bench: CelebA train bf16 B={BATCH}, a window of {args.k}",
            ours.window(), measure.card_text(line), reps=1, per=args.k,
            wall_ms=1e3 / value)
        out.update(
            tflops_sustained=flops * value / 1e12,
            mfu=measure.mfu(flops, value, measure.peak_flops(ours.model)),
            peak=measure.PEAK_SOURCE, idle_share=prof["idle_share"],
            device_ms_per_step=prof["device_ms"],
            launches_per_step=prof["launches"],
            device_ms_by_family=prof["families"],
            peak_mem_bytes=measure.peak_memory_bytes(ours.window(), device))
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
