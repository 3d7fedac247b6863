#!/usr/bin/env python3
"""Quickest proof that the PyTorch port (mvae_tpu_torch) runs on one
NVIDIA GPU: builds the CUDA kernels from `mvae_tpu_torch/csrc/`, holds each
against its plain PyTorch version on the card, drives the serving
endpoints and the HTTP front, the eval-mode ELBO, the training step and
the training CLI of the shipped CelebA model at full width, then the
MNIST, FashionMNIST,
MultiMNIST, CelebA-19 and vision families end to end (train, sample and
loglike CLIs, serving) and the CelebA sample and loglike CLIs, then
trains the CelebA protocol of the convergence gate and holds its scores
against the JAX package's rows, trains data-parallel (two ranks sharing
the card, one NCCL rank, the CLI on two processes) and on a dp4 x tp2
grid of eight ranks (the CLI too), serves over a group of two, runs the
native host ingest (the MultiMNIST compositor, the JPEG decode and the
CelebA CLI on a JPEG tree) and the port's measuring tools, and shows
that those paths went through the kernels. Each phase's `[time]` line
gives its seconds.

    python3 chip_smoke.py          # from the repository root, one GPU

Phases (any failure exits non-zero; nothing is caught but an HTTP
error status, which phase 3b reads as the status it checks):
  1. card, versions, kernel build time; the host library's build time
     (data/native.py: core, and decode where the image headers are)
  2. kernels vs their plain versions at the paths' shapes, with times:
     the PoE's forward and backward, the BCE; the four BN passes at each
     of the train step's 11 BN layers; conv2d_moments at the encoder's 3
     BN'd convs, bf16 and f32 (per-step sums too); the MNIST families'
     shapes: the PoE at D=64 (T=1 and T=3, B=100), the BCE's 784-pixel
     rows with each family's dtypes and the IWAE's 100*100 sample rows
     against 100 shared target rows; the MultiMNIST and celeba19
     shapes: the PoE at the expert cap 32 (T=21 and T=1, M=19), the
     BCE's 2500-wide rows (bf16: element loads), celeba19's (2100, 12288)
     train rows in the f32 math and the bf16 math, its eval and IWAE rows,
     the four BN passes at MultiMNIST's planes (S = 144, 36, 4, 625) and
     celeba19's decoder at G=21; vision's shapes: the PoE at T=7 and T=1
     over M=6 (the expert cap 8), B=50, D=250, the BCE's (350, 12288)
     and (350, 4096) bf16 train rows against 50 targets, its eval and
     IWAE rows, the four BN passes at its six encoders' B=50 planes and
     six decoders' G=7 planes and at the stacked groups' planes of
     --stack-modalities (three modalities' channels side by side: C =
     192, 384, 768 in the encoders, 384, 192, 96 at G=7 in the decoders),
     conv2d_moments at its B=50 convs (bf16); the grouped train step's
     shapes (phase 5b): the BCE's (200, 12288) and (200, 18) CelebA rows
     and celeba19's (300, 12288) in the bf16 math, the four BN passes at
     the decoders' live and dead planes (CelebA's G = 2 and 1, MultiMNIST's
     2 and 1, celeba19's 3 and 18);
     every kernel launched
     twice gives bit-identical results. Each kernel is timed two ways:
     device_ms (one launch between events, the L2 flushed before it:
     carries the measuring floor of the `[kernel] floor` line) and
     back_to_back_ms (R launches between one pair of events, each on its
     own copy of the inputs: the floor out)
  3. serving: Sampler on CelebaMVAE(100) in bf16 (every endpoint)
  3b. the HTTP front (mvae_tpu_torch/serve_http.py) on 127.0.0.1 around
     that Sampler, warmed up at buckets 1-64 for the conditions image,
     attrs and both: every endpoint in JSON and in the binary form
     against the direct Sampler call, bit for bit; a 400 and a 404; 16
     concurrent one-row /embed requests against their rows served alone;
     then the burst of tools/serve_http_bench.py, 16 clients x 8 one-row
     /embed requests, at the 2 ms window and at 0 ms in turns (requests/s,
     p50/p95 ms, device calls, rows a call), which fails unless the 2 ms
     window coalesces
  4. eval step: B=100, T=3, CLI weights, uint8 device-resident data, bf16
     and f32, kernel path and plain versions timed in turns
  5. train step: the same setting, Adam(1e-4), windows of K=20 steps of
     make_multi_train_step, kernel path and plain versions in turns (the
     default, unfused encoder route), then the encoder's fused route
     (conv2d_moments, opt-in) and its unfused route in turns, bf16 and
     f32
  5b. the train step's grouped decode (core/engine.py:decode_plan, the
     default for static masks and for celeba19's CLI support) against the
     one-batch decode an all-ones recon_support gives: CelebA and
     celeba19 bf16 at B=100 from the same weights and noise, one step of
     each (loss above its floor, every gradient, the running statistics
     after; FlopCounterMode's count of each equal to flops_per_step plus
     its dead work from shapes; the port kernels' launches a step), then
     windows of K=20 in turns G, O, O, G after a warm-up pair (host ms a
     step), the peak device memory of a window and a profile line of
     each (device ms, launches, idle share a step); MNIST's and
     MultiMNIST's launches a step, grouped and one batch
  6. eval checks: kernel path vs the plain versions (posteriors, loss
     above its ln 2 floor); f32 card vs CPU (posteriors, decoder logits,
     loss above its floor)
  6b. the training CLI: `experiments/celeba/train.py:main` on the
     synthetic CelebA set, CelebaMVAE(100) bf16, 2 epochs on the fused
     route (--conv-moments) into a temporary directory, --resume for a
     third on the default route with --profile-dir (its second window's
     trace, which phase 6l reads), then Sampler.from_checkpoint on
     model_best.pth.tar answers one request
  6c. the MNIST families: an IDX set of the synthetic digits (2000 train,
     500 test rows) each; the train CLI with its defaults (bf16, L=64,
     B=100) for 2 epochs, --resume for a third; the sample CLI in its
     four modes; the loglike CLI at K=100 for image, text and joint;
     Sampler.from_checkpoint at every endpoint; profile lines of a bf16
     train step (its windows' losses finite) and of an IWAE batch (K=100,
     B=100). Then the CelebA loglike CLI (K=100,
     500 rows) and sample CLI (--condition-on-attrs) from 6b's checkpoint
  6d. MultiMNIST: shards of 2000 / 500 rows from the synthetic digits;
     the train CLI with its defaults (bf16, L=64, B=100) for 2 epochs,
     --resume for a third; the sample CLI from the prior and conditioned
     on a digit string, an image of it and both; the loglike CLI at K=100
     for image, text and joint; Sampler.from_checkpoint at every endpoint;
     profile lines of a bf16 step and of an IWAE batch
  6e. celeba19 on 6b's synthetic CelebA set: the train CLI in bf16 at
     --approx-m 1 (T=21; the image BCE's bf16 math) for 2 epochs on the
     fused route, --resume for a third with --fast-term-decode;
     the sample CLI (prior, --condition-on-attrs Smiling); the joint
     loglike CLI at K=100; Sampler.from_checkpoint; profile lines of the
     train step, reference-exact and fast, and of an IWAE batch
  6f. vision on 6b's synthetic CelebA set: derive_modalities on the card
     (timed, its hysteresis iterations), the train CLI at its defaults
     (bf16, L=250, B=50, T=7 terms that each reconstruct all six
     modalities) for 2 epochs on the fused route, --resume for a third
     streamed from the host (--no-device-data), a reconstruction grid each
     epoch; the sample CLI conditioned on a test image read as
     each of the six modalities; the joint loglike CLI at K=100;
     Sampler.from_checkpoint at every endpoint; profile lines of the bf16
     step and of an IWAE batch (two decode chunks); a profile line of the
     step of --stack-modalities (each group of three modalities one
     grouped stack) and of the loop, and one epoch of the train CLI with
     --stack-modalities (the steps' time is 6k's)
  6g. the convergence gate's main path: the runner of
     mvae_tpu_torch/tools/parity_convergence.py on the CelebA protocol in
     bf16 at seed 0 (CelebaMVAE(100), the synthetic set of 2000 / 500
     rows, 12 epochs of 20 steps, the test ELBO on 500 rows, IWAE-100
     and IWAE-500 on 200), the row held against the JAX f32 three-seed
     mean of PARITY_convergence.json: a gap over twice the JAX spread s
     in any metric fails the run (the strict gate, one s, is the row
     file's)
  6h. data parallelism (mvae_tpu_torch/parallel/): two ranks spawned on
     the card over gloo (tools/dp_check.py:spawn_ranks), CelebaMVAE(100) at
     the CLI weights, bf16 and f32, unfused and fused routes, each rank
     stepping its 50 rows of three global batches of 100 against this
     process on the whole batches with the same noise: step 1's loss,
     every gradient after the all-reduce, the running statistics and the
     parameters, then the losses of steps 2-3 and both ranks' state
     equal, each rank's launches of the BN reductions, the PoE, the BCE
     and conv2d_moments; then the same two ranks serve 6b's
     model_best.pth.tar through Sampler(dp=2), every endpoint against one
     device; then the dp step under a process group of one
     NCCL rank against the step with no group, bf16 B=100, in turns, with
     launches and all-reduces a step, one all-reduce's host cost and
     profile lines; then the CelebA train CLI as two processes
     (--coordinator, --process-id, --n-processes) for an epoch, rank 0
     alone logging and writing, Sampler.from_checkpoint on its
     model_best.pth.tar
  6i. tensor and expert parallelism (parallel/mesh.py's grid): eight ranks
     spawned on the card over gloo at global B=100, the JAX package's
     dp4 x tp2, against this process on the whole batches with the same
     noise: CelebaMVAE(100) at the CLI weights, bf16 on the unfused route
     and f32 on the fused one, and celeba19 in bf16 with the CLI's recon
     support (9 of 18 experts a rank, the gathered ones it holds): step
     1's loss,
     every gradient gathered to full shape, the running statistics and
     the parameters, then the losses of steps 2-3 and every rank's state
     equal, each rank's launches and its collectives a step on the dp and
     the tp group; then on the same eight ranks the CelebA CLI's main
     (JAX's mesh line), an epoch and a --resume, its model_best.pth.tar
     loaded on one device; then serve_http at --dp 2 and --dp 1 side by
     side (started together), the same request to each and
     serve_http_bench's burst in turns (requests/s, p50)
  6j. the native host ingest (data/native.py) on the card's host: the CPU,
     g++ and the image headers' versions, each part's probe; make_dataset
     at MultiMNIST's canonical 60000 / 10000 rows on the native
     compositor, twice and bit for bit alike, against the numpy path at
     2000 rows, the JAX package's validity checks and the shards read
     back; a tree of the synthetic CelebA set's 2500 rows as 178x218
     JPEGs (and four PNGs) loaded natively and with exact_decode in turns
     (images/s, the pixel gap held under 4/255); the CelebA train CLI on
     it for two epochs by default and with --exact-decode (load wall,
     Throughput, finite losses). Without the image headers the native
     decode's part is skipped, said so, and the tree's loads and CLI runs
     go through PIL
  6k. the measuring tools (mvae_tpu_torch/tools/) at full width:
     tools/bench.py at --k 20 --windows 5 (CelebA bf16 steps/s against
     the reference flow in turns, mfu, the idle share, peak memory),
     tools/bench_families.py --bf16 --flops --k 20 (all six families),
     tools/roofline_family.py --family celeba --bf16 --top 10 and
     tools/serve_latency.py for celeba (6b's checkpoint) and mnist: every
     JSON line parses, every mfu in (0, 1.05], every idle share in [0, 1];
     then FlopCounterMode's count of one shipped CelebA step equal to the
     FLOPs from shapes plus the grouped decode's dead forwards
  6l. tools/roofline_celeba.py on 6b's traced window (CelebaMVAE(100)
     bf16, B=100, T=3, the default route): device ms, launches and kernel
     families a step, the FLOPs, bytes_ops and bytes_floor of the step
     from shapes and its bound, whose share of the device ms must lie in
     (0, 1.05]; each distinct kernel of the window printed once with the
     op that launched it and its family, and every kernel a convolution
     op launched in the conv family (by the op and by its name); then
     tools/profile_celeba19.py at K=20, f32 and bf16: celeba19's seven
     stages, each with positive wall ms, device ms and launches
  7. train checks: one step on the fused route, kernel path vs plain
     versions (loss, parameter gradients: all eight kernels), bf16 and
     f32; fused vs unfused encoder route
     (loss, gradients, the encoder BNs' running statistics); f32 card vs
     CPU (TF32 off) on one step with the same noise; the loss of the last
     window below the first's; running statistics finite and moved;
     the IWAE estimate, kernel path vs plain versions (MNIST, CelebA,
     K=100, B=100) and f32 card vs CPU; for MultiMNIST and celeba19 one
     train step, kernel path vs plain versions (loss above its floor,
     every gradient) in bf16 and f32 (celeba19 in bf16 with the BCE's bf16
     math and its f32 math), and f32 card vs CPU; the same for vision's
     T=7 step, with --stack-modalities against the loop (loss, gradients,
     running statistics) in bf16 and f32, and Canny on the card against
     the CPU (edges equal but at ties)
  The fashionmnist and multimnist bf16 steps are also timed with cuDNN's
  defaults against cudnn.deterministic (the convergence runner's flags)
  in turns, and one window of each runs under
  torch.use_deterministic_algorithms(warn_only=True), whose warnings name
  the ops with no deterministic form.
  8. the kernels line: launches on phases 3-5b and 6b-6l (6h's and 6i's
     spawned ranks' own included), error, times,
     bounds, and each timed case of the PoE, the BCE and the families'
     BN layers
Phases 3-5 and 6c-6f end with a torch.profiler breakdown of device time
per call (tools/measure.py:profile_breakdown).
Weights are random from seed 0, the BN statistics and affine parameters
too. The last line is {"ok": true, "device": {...}}.

Times come from CUDA events (kernels) or the host clock around work that
ends in a synchronize (endpoints, steps, windows), on whatever card
`nvidia-smi` names; the bounds use that card's published memory rate and
its f32 rate, or for the bf16 convolutions its bf16 tensor-core rate.
"""

import contextlib
import copy
import ctypes
import datetime
import json
import math
import os
import platform
import re
import shutil
import signal
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
import warnings

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

from mvae_tpu_torch import ops
from mvae_tpu_torch.core.engine import (
    decode_plan, multi_term_elbo, static_support)
from mvae_tpu_torch.core.loglike import iwae_log_marginal
from mvae_tpu_torch.data import native as host_native
from mvae_tpu_torch.data.celeba import (
    ATTR_IX_TO_KEEP, load_celeba, synthetic_celeba)
from mvae_tpu_torch.data.mnist import load_mnist, synthetic_mnist, write_idx
from mvae_tpu_torch.experiments.celeba import loglike as celeba_loglike
from mvae_tpu_torch.experiments.celeba import sample as celeba_sample
from mvae_tpu_torch.experiments.celeba import train as celeba_cli
from mvae_tpu_torch.experiments.fashionmnist import (
    loglike as fashion_loglike, sample as fashion_sample,
    train as fashion_train)
from mvae_tpu_torch.experiments.celeba19 import (
    loglike as c19_loglike, sample as c19_sample, train as c19_train)
from mvae_tpu_torch.experiments.mnist import (
    loglike as mnist_loglike, sample as mnist_sample, train as mnist_train)
from mvae_tpu_torch.experiments.multimnist import (
    loglike as mm_loglike, sample as mm_sample, train as mm_train)
from mvae_tpu_torch.core.subsets import (
    celeba19_recon_support, celeba19_step_terms)
from mvae_tpu_torch.data.multimnist import (
    SEED as MM_SEED, load_multimnist, make_dataset, mk_dataset)
from mvae_tpu_torch.data.pipeline import ArrayDataset
from mvae_tpu_torch.data.vision import derive_modalities, load_celeb_vision
from mvae_tpu_torch.experiments.vision import (
    loglike as v_loglike, sample as v_sample, train as v_train)
from mvae_tpu_torch.image import transforms as image_ops
from mvae_tpu_torch.data.text import decode_tokens
from mvae_tpu_torch.models import (
    Celeba19MVAE, FashionMnistMVAE, MnistMVAE, MultiMnistMVAE, VisionMVAE)
from mvae_tpu_torch.models.vision import (
    CHANNELS as V_CHANNELS, MODALITIES as V_MODALITIES)
from mvae_tpu_torch.models.celeba import CelebaMVAE
from mvae_tpu_torch.nn.norm import BatchNorm
from mvae_tpu_torch.ops import bn as bn_ops
from mvae_tpu_torch.ops import convbn
from mvae_tpu_torch.ops.elbo import bce_rowsum_plain
from mvae_tpu_torch.ops.poe import poe_bwd_plain, poe_plain
from mvae_tpu_torch.parallel.collectives import all_reduce_sum, sum_in_place
from mvae_tpu_torch.parallel.mesh import data_parallel, grid
from mvae_tpu_torch.serve import Sampler
from mvae_tpu_torch.serve_http import (
    ServeApp, decode_array, encode_array, make_server, warmup_buckets)
from mvae_tpu_torch.tools import dp_check
from mvae_tpu_torch.tools.dp_check import TimedLines
from mvae_tpu_torch.tools import bench as bench_tool
from mvae_tpu_torch.tools import (
    bench_families, measure, profile_celeba19, roofline_celeba,
    roofline_family, serve_http_bench, serve_latency)
from mvae_tpu_torch.tools import parity_convergence as parity
from mvae_tpu_torch.tools.measure import host_ms, profile_breakdown
from mvae_tpu_torch.train.checkpoint import BEST, CKPT
from mvae_tpu_torch.train.driver import to_device_data
from mvae_tpu_torch.train.loop import (
    decode_batch, draw_noise, make_eval_step, make_multi_train_step,
    make_train_step, resolve_decode_dtype)
from mvae_tpu_torch.utils.png import write_png

MASKS = [[1.0, 1.0], [1.0, 0.0], [0.0, 1.0]]
LAMBDAS = [[1.0, 10.0]] * 3        # experiments/celeba/train.py:21
ELEMENTS = (64 * 64 * 3, 18)       # per row: image, attrs (modalities order)
# kernel vs plain on the card: both f32, sums in another order
POE_TOL = dict(rtol=1e-5, atol=1e-6)
BCE_TOL = dict(rtol=1e-5, atol=1e-4)
# eval step's loss above its ln 2 floor, kernel path vs plain versions:
# f32 at the golden tolerance; bf16 decodes through bf16 convolutions,
# where a last-bit change in z can move a rounding, so the bound is looser
STEP_RTOL = {torch.float32: 1e-4, torch.bfloat16: 1e-3}
# f32 card vs CPU (TF32 off): cuDNN/cuBLAS and oneDNN sum in other orders;
# the tolerance of the port's module tests
CARD_TOL = dict(rtol=1e-4, atol=1e-5)

# the train step's BN kernels against their plain versions on the card:
# sums over up to 102400 elements in another order (compared as means,
# so the tolerance is per element); f32 y and dx from the same formula
# with a last-bit difference in exp; in bf16 both round one f32 value, so
# a rare rounding moves by one bf16 step (2^-8 relative, 2^-7 allowed)
BN_SUM_TOL = dict(rtol=1e-5, atol=1e-6)
BN_OUT_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
              torch.bfloat16: dict(rtol=2 ** -7, atol=1e-5)}
# bn_dx's dscale and dbias add the groups' (C,) terms in another order than
# torch.sum; at celeba19's G = 21 the terms cancel, so they are held to the
# bound of a reordered f32 sum: this times the terms' summed magnitudes
GROUP_SUM_RTOL = 1e-5
# one train step, kernel path vs plain versions: the loss above its ln 2
# floor as in the eval checks; each parameter's gradient in relative
# Frobenius norm: f32 at 1e-4 (the port vs JAX read 5.5e-6 on the CPU);
# bf16 at 5e-2, as a last-bit change before a bf16 rounding flips it and
# the flips propagate (the port vs JAX in bf16 read up to 2e-2 mean
# relative on the CPU); the Linear biases that feed a BN have an exact
# gradient of 0, both sides return rounding noise, held absolutely
GRAD_RTOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
# conv2d_moments against its plain version (cuDNN, TF32 off): f32 y sums
# up to 2048 products in another order; bf16 y rounds an f32 accumulator
# once on both sides, so a rare y sits one bf16 step apart (2^-7
# relative); the sums compared as means over the B*OH*OW pixels, a few
# such steps moving a bf16 mean by far less than 1e-4
CONV_Y_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-4),
              torch.bfloat16: dict(rtol=2 ** -7, atol=1e-5)}
CONV_SUM_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
                torch.bfloat16: dict(rtol=1e-4, atol=1e-4)}
# the encoder BNs' running statistics after one step, fused vs unfused
# route: in f32 the same batch moments from sums in another order; in bf16
# the second and third convs read another input, as the fused route's
# swish rounds in JAX's five bf16 steps and the BN kernel's once from f32
# (a CPU rehearsal at B=100 read 8.4e-5 at most)
EMA_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-6),
           torch.bfloat16: dict(rtol=1e-3, atol=5e-4)}
GRAD_NOISE_ATOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# one train step, the encoder's fused route vs its unfused one, at
# GRAD_RTOL: the fused route's BN backward folds y's cotangent with the
# moments' in f32 and rounds once, as the BN kernel's dx does
# (ops/convbn.py)
BATCH, N_DATA = 100, 1000    # rows a step; rows of the resident dataset
TRAIN_K = 20            # steps per window
PROFILE_K = 5           # ... of the windows that run under the profiler
LR = 1e-4               # experiments/celeba/train.py: lr 1e-4

KERNELS = {
    "poe_fwd": dict(route="cuda", source="mvae_tpu_torch/csrc/poe.cu",
                    replaces="mvae_tpu/ops/poe_pallas.py:28"),
    "poe_bwd": dict(route="cuda", source="mvae_tpu_torch/csrc/poe.cu",
                    replaces="mvae_tpu/ops/poe_pallas.py:91 (_bwd, the "
                    "closed-form backward; not a Pallas kernel)"),
    "bce_rowsum_fwd": dict(route="cuda",
                           source="mvae_tpu_torch/csrc/bce_rowsum.cu",
                           replaces="mvae_tpu/ops/elbo_pallas.py:21"),
    "bn_moments": dict(route="cuda", source="mvae_tpu_torch/csrc/bn_swish.cu",
                       replaces="mvae_tpu/ops/bn_pallas.py:92"),
    "bn_normalize": dict(route="cuda",
                         source="mvae_tpu_torch/csrc/bn_swish.cu",
                         replaces="mvae_tpu/ops/bn_pallas.py:102"),
    "bn_bwd_partials": dict(route="cuda",
                            source="mvae_tpu_torch/csrc/bn_swish.cu",
                            replaces="mvae_tpu/ops/bn_pallas.py:107"),
    "bn_dx": dict(route="cuda", source="mvae_tpu_torch/csrc/bn_swish.cu",
                  replaces="mvae_tpu/ops/bn_pallas.py:120"),
    "conv2d_moments": dict(route="cuda",
                           source="mvae_tpu_torch/csrc/conv_moments.cu",
                           replaces="mvae_tpu/ops/convbn_pallas.py:116"),
}
BN_KERNELS = ("bn_moments", "bn_normalize", "bn_bwd_partials", "bn_dx")

# the BN layers of the train step under bf16 compute: (layer, how many
# such layers, G, N, C, S, dtype). G = 3 terms in the decoders. The
# encoder's three conv BNs take the BN kernels only on the unfused route
# (the default); the fused route (conv_moments=True) folds their moments into
# conv2d_moments (ENC_CONV_BN).
BN_LAYERS = (
    ("image enc conv2", 1, 1, 100, 64, 256, torch.bfloat16),
    ("image enc conv3", 1, 1, 100, 128, 64, torch.bfloat16),
    ("image enc conv4", 1, 1, 100, 256, 25, torch.bfloat16),
    ("attrs enc BN1d", 2, 1, 100, 512, 1, torch.float32),
    ("image dec convT1", 1, 3, 100, 128, 64, torch.bfloat16),
    ("image dec convT2", 1, 3, 100, 64, 256, torch.bfloat16),
    ("image dec convT3", 1, 3, 100, 32, 1024, torch.bfloat16),
    ("attrs dec BN1d", 3, 3, 100, 512, 1, torch.float32),
)
# the BN layers of the MultiMNIST and celeba19 bf16 train steps at
# B=100 that CelebA's do not cover: MultiMNIST's planes of S = 144, 36, 4
# (encoder) and 36, 144, 625 (decoder, G = 3), whose bf16 S but 144 holds
# no whole 16-byte chunk, and celeba19's decoder at G = 21 terms (its
# encoder's are CelebA's); timed, apart from CelebA's per-step sums
FAMILY_BN_LAYERS = (
    ("multimnist enc conv2", 1, 1, 100, 64, 144, torch.bfloat16),
    ("multimnist enc conv3", 1, 1, 100, 128, 36, torch.bfloat16),
    ("multimnist enc conv4", 1, 1, 100, 256, 4, torch.bfloat16),
    ("multimnist dec convT1", 1, 3, 100, 128, 36, torch.bfloat16),
    ("multimnist dec convT2", 1, 3, 100, 64, 144, torch.bfloat16),
    ("multimnist dec convT3", 1, 3, 100, 32, 625, torch.bfloat16),
    ("celeba19 dec convT1", 1, 21, 100, 128, 64, torch.bfloat16),
    ("celeba19 dec convT2", 1, 21, 100, 64, 256, torch.bfloat16),
    ("celeba19 dec convT3", 1, 21, 100, 32, 1024, torch.bfloat16),
    # the grouped train step's decoder planes (core/engine.py:decode_plan):
    # the live terms' call and the dead terms' (forward passes alone)
    ("celeba dec convT3 live", 1, 2, 100, 32, 1024, torch.bfloat16),
    ("celeba dec convT3 dead", 1, 1, 100, 32, 1024, torch.bfloat16),
    ("celeba attrs dec BN1d live", 3, 2, 100, 512, 1, torch.float32),
    ("celeba attrs dec BN1d dead", 3, 1, 100, 512, 1, torch.float32),
    ("multimnist dec convT3 live", 1, 2, 100, 32, 625, torch.bfloat16),
    ("multimnist dec convT3 dead", 1, 1, 100, 32, 625, torch.bfloat16),
    ("celeba19 dec convT3 live", 1, 3, 100, 32, 1024, torch.bfloat16),
    ("celeba19 dec convT3 dead", 1, 18, 100, 32, 1024, torch.bfloat16),
)
# the BN layers of vision's bf16 train step at its B=50: six encoders'
# (B = 50 rows) and six decoders' (G = 7 terms), "x6 per step"; timed
# apart from CelebA's per-step sums
VISION_BN_LAYERS = (
    ("vision enc conv2", 6, 1, 50, 64, 256, torch.bfloat16),
    ("vision enc conv3", 6, 1, 50, 128, 64, torch.bfloat16),
    ("vision enc conv4", 6, 1, 50, 256, 25, torch.bfloat16),
    ("vision dec convT1", 6, 7, 50, 128, 64, torch.bfloat16),
    ("vision dec convT2", 6, 7, 50, 64, 256, torch.bfloat16),
    ("vision dec convT3", 6, 7, 50, 32, 1024, torch.bfloat16),
    # --stack-modalities: each group of three modalities as one stack,
    # their channels side by side (two groups a step)
    ("vision stacked enc conv2", 2, 1, 50, 192, 256, torch.bfloat16),
    ("vision stacked enc conv3", 2, 1, 50, 384, 64, torch.bfloat16),
    ("vision stacked enc conv4", 2, 1, 50, 768, 25, torch.bfloat16),
    ("vision stacked dec convT1", 2, 7, 50, 384, 64, torch.bfloat16),
    ("vision stacked dec convT2", 2, 7, 50, 192, 256, torch.bfloat16),
    ("vision stacked dec convT3", 2, 7, 50, 96, 1024, torch.bfloat16),
)
BN_MAIN_LAYER = "image dec convT3"      # the largest launch
ENC_CONV_BN = ("image enc conv2", "image enc conv3", "image enc conv4")
# the encoder's BN'd convs at B=100: (layer, B, C_in, H, C_out, stride,
# padding)
CONV_LAYERS = (("image enc conv2", 100, 32, 32, 64, 2, 1),
               ("image enc conv3", 100, 64, 16, 128, 2, 1),
               ("image enc conv4", 100, 128, 8, 256, 1, 0))
CONV_MAIN = ("image enc conv2", torch.bfloat16)
# vision's six encoders' BN'd convs on the fused route, B=50, bf16
VISION_CONV_LAYERS = (("vision enc conv2", 50, 32, 32, 64, 2, 1),
                      ("vision enc conv3", 50, 64, 16, 128, 2, 1),
                      ("vision enc conv4", 50, 128, 8, 256, 1, 0))
CLI_EPOCHS = 2          # then --resume for one more


def card_peaks(name):
    """(memory bytes/s, f32 non-tensor FLOP/s, bf16 dense tensor-core
    FLOP/s): published peaks of the card, SXM unless the name says
    otherwise."""
    if "H100" in name and "PCIe" in name:
        return 2.0e12, 51e12, 756e12
    if "H100 NVL" in name:
        return 3.9e12, 60e12, 835e12
    if "H200" in name:
        return 4.8e12, 67e12, 989e12
    return 3.35e12, 67e12, 989e12


def device_ms(fn, flush, reps=60):
    """Median device time of fn() in ms: CUDA events around each call, the
    calls queued behind a sleep so the host's launch cost stays out, the
    L2 cache flushed before each call (the path finds its inputs cold) by
    reading a 256 MB buffer: the cache then holds clean lines, so the timed
    call pays no write-back of an earlier call's (or a zeroing flush's)
    dirty lines."""
    fn()
    torch.cuda.synchronize()
    events = []
    for i in range(reps):
        if i % 10 == 0:
            torch.cuda._sleep(20_000_000)
        flush.max()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        events.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in events)


BATCH_BYTES = 100 * 2 ** 20   # back_to_back_ms: the copies, where
BATCH_LAUNCHES = (8, 256)      # ... these launches a batch allow
SLEEP_CYCLES_PER_S = 2e9       # above the card's clock: a sleep long enough


def back_to_back_ms(fn, args, flush, reps=5):
    """Median device time a launch of fn(*args) without the measuring
    floor: R launches back to back between one pair of CUDA events, each
    on its own copy of the tensors in args (outputs kept until the batch
    ends). The L2 is flushed before each batch and each copy is read by
    one launch only, so no launch finds its inputs in L2, whatever R. R
    is the launches whose copies come to BATCH_BYTES (twice the L2), within
    BATCH_LAUNCHES: a small input's batch stops at the upper bound, short
    of BATCH_BYTES. The batch is queued behind a sleep twice as long as the
    host takes to queue it."""
    nbytes = sum(a.numel() * a.element_size() for a in args
                 if torch.is_tensor(a))
    lo, hi = BATCH_LAUNCHES
    r = min(hi, max(lo, -(-BATCH_BYTES // nbytes)))
    copies = [tuple(a.clone() if torch.is_tensor(a) else a for a in args)
              for _ in range(r)]
    keep = [fn(*c) for c in copies]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    keep = [fn(*c) for c in copies]
    torch.cuda.synchronize()
    queue_s = time.perf_counter() - t0
    out = []
    for _ in range(reps):
        del keep
        flush.max()
        torch.cuda._sleep(int(2 * queue_s * SLEEP_CYCLES_PER_S))
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        keep = [fn(*c) for c in copies]
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b) / r)
    return statistics.median(out)


def reduction_at(op, geo):
    """bn_moments (op "moments") or bn_bwd_partials ("partials") launched
    through its C entry point at the 6-int geometry geo (csrc/bn_swish.cu:
    reduce_of) in place of the wrapper's: a reading, not the main path (no
    launch count)."""
    lib = ops._cuda.library()
    arr = (ctypes.c_int * 6)(*geo)

    def fn(x4, *rest):
        gsz, _, c, _ = x4.shape
        s = torch.empty((gsz, c), device=x4.device)
        q = torch.empty_like(s)
        st = ops._cuda.stream(x4.device)
        bf16 = int(x4.dtype == torch.bfloat16)
        if op == "moments":
            rc = lib.mvae_bn_moments(x4.data_ptr(), bf16, s.data_ptr(),
                                     q.data_ptr(), *x4.shape, arr, st)
        else:
            g4, a, b = rest
            rc = lib.mvae_bn_bwd_partials(
                x4.data_ptr(), g4.data_ptr(), bf16, a.data_ptr(),
                b.data_ptr(), s.data_ptr(), q.data_ptr(), *x4.shape, arr, st)
        ops._cuda.check(f"bn {op} at {geo}", rc)
        return s, q
    return fn


def bound(nbytes, nops, peaks, rate=None):
    """The least ms for nbytes at the memory rate and nops at `rate` (the
    f32 rate unless given)."""
    rate = peaks[1] if rate is None else rate
    t_bytes, t_ops = nbytes / peaks[0] * 1e3, nops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernels(dev, card, peaks, flush):
    """Each kernel against its plain version at the shapes of the paths."""
    g = torch.Generator(device=dev).manual_seed(0)
    rows = {}

    def report(name, case, got, want, tol, t_k, t_b2b, t_p, t_lib, nbytes,
               nops, main):
        torch.testing.assert_close(got, want, **tol)
        err = (got - want).abs().max().item()
        rel = ((got - want).abs() / want.abs().clamp_min(1e-30)).max().item()
        b_ms, b_by = bound(nbytes, nops, peaks)
        print(f"[kernel] {name} {case}: max_abs_err {err} max_rel_err {rel} "
              f"ms {t_k} back_to_back_ms {t_b2b} plain_ms {t_p} library_ms "
              f"{t_lib} bound_ms {b_ms} ({b_by}) | {card}")
        row = rows.setdefault(name, {"max_abs_err": 0.0, "cases": []})
        row["max_abs_err"] = max(row["max_abs_err"], err)
        row["cases"].append(dict(case=case, ms=t_k, back_to_back_ms=t_b2b,
                                 plain_ms=t_p, library_ms=t_lib,
                                 bound_ms=b_ms, bound_by=b_by))
        if main:
            row.update(ms=t_k, back_to_back_ms=t_b2b, plain_ms=t_p,
                       library_ms=t_lib, bound_ms=b_ms, bound_by=b_by,
                       case=case)
        return f"{case}: ms {t_k} back_to_back_ms {t_b2b} bound_ms {b_ms}"

    # the PoE's upstream gradients from their own generator, so that the
    # other kernels' inputs stay those of earlier trees
    g_up = torch.Generator(device=dev).manual_seed(7)
    # the MNIST families' cases (D = 64: the IWAE's proposal and infer at
    # T = 1, the train step at T = 3) draw from their own generator too
    g_fam = torch.Generator(device=dev).manual_seed(8)
    # celeba19's: a step's 21 terms and infer's / the IWAE
    # proposal's one row over its 19 experts, at the expert cap 32
    g_19 = torch.Generator(device=dev).manual_seed(9)
    step19 = celeba19_step_terms(np.random.default_rng(0), 1, 18, 1.0,
                                 10.0)[0].tolist()
    # vision's: a step's 7 terms and infer's / the IWAE proposal's one row
    # over its 6 experts (the expert cap 8), B=50, D=250
    g_v = torch.Generator(device=dev).manual_seed(12)
    for t, m, b, d, gen, rows_ in (
            (1, 2, 1, 100, g, None), (1, 2, 64, 100, g, None),
            (3, 2, 100, 100, g, None), (1, 2, 100, 64, g_fam, None),
            (3, 2, 100, 64, g_fam, None), (21, 19, 100, 100, g_19, step19),
            (1, 19, 100, 100, g_19, [[1.0] * 19]),
            (7, 6, 50, 250, g_v, v_train.TERM_MASKS.tolist()),
            (1, 6, 50, 250, g_v, [[1.0] * 6])):
        mu = torch.randn((m, b, d), generator=gen, device=dev)
        lv = torch.randn((m, b, d), generator=gen, device=dev)
        if rows_ is None:
            rows_ = MASKS[:t] if t == 3 else [[1.0, 1.0]]
        masks = torch.tensor(rows_, device=dev)
        g_mu, g_lv = torch.randn((2, t, b, d), device=dev, generator=(
            g_up if gen is g else gen))
        c, case = b * d, f"T={t} M={m} B={b} D={d}"
        # (name, kernel, plain version, inputs, bytes, operations)
        for name, kern, plain, args, nbytes, nops in (
                ("poe_fwd", ops.poe_fwd, poe_plain, (mu, lv, masks),
                 4 * (2 * m * c + t * m + 2 * t * c),
                 c * (4 * m + t * (4 * m + 4))),
                ("poe_bwd", ops.poe_bwd, poe_bwd_plain,
                 (mu, lv, masks, g_mu, g_lv),
                 4 * (4 * m * c + 2 * t * c + t * m),
                 c * (9 * m + t * (9 * m + 6)))):
            got = torch.cat(kern(*args))
            expect(torch.equal(got, torch.cat(kern(*args))),
                   f"{name} {case}: two launches differ")
            report(name, case, got, torch.cat(plain(*args)), POE_TOL,
                   device_ms(lambda: kern(*args), flush),
                   back_to_back_ms(kern, args, flush),
                   device_ms(lambda: plain(*args), flush), None, nbytes,
                   nops, main=(t == 3 and d == 100))

    f32, bf16 = torch.float32, torch.bfloat16
    # (rows, target rows, width, logits dtype, targets dtype, main case):
    # the eval step's image and attribute rows under bf16 compute (f32
    # logits; the main case) and the train step's image rows (bf16 logits);
    # then the MNIST families' 784 pixels (their own generator): MNIST's
    # steps (f32 logits, f32 targets: its flat rows stay f32 on the card),
    # FashionMNIST's bf16 train step (bf16 both) and eval step (f32 logits,
    # bf16 targets), and the IWAE's K * B = 100 * 100 sample rows against
    # the B target rows (f32, the loglike CLI's)
    # MultiMNIST's 2500 pixels (the bf16 train step, element loads;
    # the eval step; the IWAE's sample rows), celeba19's train step (2100
    # rows against 100 targets) in the f32 math and the bf16 math, its
    # joint eval and its IWAE's image rows; their own generator; then
    # vision's (their own generator too): the bf16 train step's T * B = 350
    # rows against 50 targets, 12288 wide (image, obscured, watermark) and
    # 4096 (gray, edge, mask), the joint eval's 50 rows of each, the IWAE's
    # chunk of 50 samples of 100 rows of each (f32); then the grouped
    # train step's rows (core/engine.py:decode_plan): CelebA's image and
    # attribute rows of its two live terms, celeba19's image rows of its
    # three (the bf16 math)
    g_new = torch.Generator(device=dev).manual_seed(10)
    g_vis = torch.Generator(device=dev).manual_seed(13)
    bce_main = {}
    for i, (n, nt, k, xdt, tdt, main, bf) in enumerate((
            (300, 300, 12288, f32, f32, False, False),
            (300, 300, 12288, f32, bf16, False, False),
            (300, 100, 12288, f32, bf16, "eval", False),
            (300, 100, 12288, bf16, bf16, "train", False),
            (300, 300, 18, f32, f32, False, False),
            (300, 100, 18, f32, f32, False, False),
            (300, 100, 784, f32, f32, False, False),
            (300, 100, 784, bf16, bf16, False, False),
            (300, 100, 784, f32, bf16, False, False),
            (10000, 100, 784, f32, f32, False, False),
            (300, 100, 2500, bf16, bf16, False, False),
            (300, 100, 2500, f32, bf16, False, False),
            (10000, 100, 2500, f32, f32, False, False),
            (2100, 100, 12288, bf16, bf16, "c19 f32 math", False),
            (2100, 100, 12288, bf16, bf16, "c19 bf16 math", True),
            (100, 100, 12288, f32, bf16, False, False),
            (10000, 100, 12288, f32, f32, False, False),
            (350, 50, 12288, bf16, bf16, False, False),
            (350, 50, 4096, bf16, bf16, "vision train 4096", False),
            (50, 50, 12288, f32, bf16, False, False),
            (50, 50, 4096, f32, bf16, False, False),
            (5000, 100, 12288, f32, f32, False, False),
            (5000, 100, 4096, f32, f32, False, False),
            (200, 100, 12288, bf16, bf16, "grouped train", False),
            (200, 100, 18, f32, f32, False, False),
            (300, 100, 12288, bf16, bf16, "c19 grouped", True))):
        gen = (g_vis if i >= 17 else g_new if i >= 10
               else (g if k != 784 else g_fam))
        if main in ("c19 f32 math", "c19 bf16 math"):   # the same inputs
            gen = torch.Generator(device=dev).manual_seed(11)
        x = (3 * torch.randn((n, k), generator=gen, device=dev)).to(xdt)
        tt = torch.rand((nt, k), generator=gen, device=dev).to(tdt)
        got = ops.bce_rowsum_fwd(x, tt, bf)
        want = bce_rowsum_plain(x, tt, bf)
        expect(torch.equal(got, ops.bce_rowsum_fwd(x, tt, bf)),
               f"bce_rowsum_fwd ({n},{k}) bf16_math={bf}: two launches "
               f"differ")
        case = (f"logits ({n},{k}) {str(xdt).split('.')[-1]}, targets "
                f"({nt},{k}) {str(tdt).split('.')[-1]}"
                + (", bf16 math" if bf else ""))
        # the library call takes one dtype: bf16 logits and targets are
        # upcast to f32 beforehand (twice their bytes), but for the bf16
        # math, which it computes in bf16; the nt target rows broadcast
        # over the n // nt terms, as the kernel reads them
        r = n // nt
        x3, t3 = x.view(r, nt, k), tt.to(x.dtype).expand(r, nt, k)
        if not bf:
            x3, t3 = x3.float(), t3.float()
        line = report(
            "bce_rowsum_fwd", case, got, want, BCE_TOL,
            device_ms(lambda: ops.bce_rowsum_fwd(x, tt, bf), flush),
            back_to_back_ms(ops.bce_rowsum_fwd, (x, tt, bf), flush),
            device_ms(lambda: bce_rowsum_plain(x, tt, bf), flush),
            device_ms(lambda: F.binary_cross_entropy_with_logits(
                x3, t3, reduction="none").sum(-1), flush),
            n * k * x.element_size() + nt * k * tt.element_size() + n * 4,
            9 * n * k, main == "eval")
        if main:
            bce_main[main] = line
        del x, tt, x3, t3
    print(f"[kernel] bce_rowsum_fwd main cases: eval step {bce_main['eval']}"
          f"; train step {bce_main['train']} | {card}")
    print(f"[kernel] bce_rowsum_fwd celeba19 train step, (2100, 12288) bf16: "
          f"f32 math {bce_main['c19 f32 math']}; bf16 math "
          f"{bce_main['c19 bf16 math']} | {card}")
    print(f"[kernel] bce_rowsum_fwd vision train step, (350, 4096) bf16 "
          f"rows: {bce_main['vision train 4096']} | {card}")
    print(f"[kernel] bce_rowsum_fwd grouped train steps: CelebA's (200, "
          f"12288) bf16 image rows {bce_main['grouped train']}; celeba19's "
          f"(300, 12288), bf16 math {bce_main['c19 grouped']} | {card}")
    return rows


def phase_bn_kernels(dev, card, peaks, flush):
    """The four BN passes against their plain versions at every BN layer
    of the train step, timed both ways, with per-step sums over the 8
    layers of the fused route and the 11 of the unfused one (the default);
    the bf16
    conv layers again in f32 (the --f32 step), checked, not timed. y and
    dx at BN_OUT_TOL, every (G, C) or (C,) output at BN_SUM_TOL (the sums
    as means); each pass launched twice gives bit-identical outputs."""
    g = torch.Generator(device=dev).manual_seed(1)
    rows = {k: {"max_abs_err": 0.0} for k in BN_KERNELS}
    keys = ("ms", "back_to_back_ms", "plain_ms", "library_ms", "bound_ms")
    per_step = {route: {k: dict.fromkeys(keys, 0.0) for k in BN_KERNELS}
                for route in ("fused", "unfused")}
    cases = [layer + (True,) for layer in BN_LAYERS] + [
        (name + " (f32)", n, gg, nn, c, sp, torch.float32, False)
        for name, n, gg, nn, c, sp, dt in BN_LAYERS if dt == torch.bfloat16
    ] + [layer + ("family",) for layer in FAMILY_BN_LAYERS + VISION_BN_LAYERS]
    for layer, count, gsz, n, c, sp, dt, timed in cases:
        x4 = (0.5 + 1.5 * torch.randn((gsz, n, c, sp), generator=g,
                                      device=dev)).to(dt)
        g4 = torch.randn((gsz, n, c, sp), generator=g, device=dev).to(dt)
        scale = 1.0 + 0.2 * torch.randn(c, generator=g, device=dev)
        bias = 0.2 * torch.randn(c, generator=g, device=dev)
        m = n * sp
        s_p, q_p = bn_ops.bn_moments_plain(x4)
        _, mean, _, a, b, invstd = bn_ops.bn_normalize_plain(
            x4, s_p, q_p, m, scale, bias)
        sdz_p, sdzx_p = bn_ops.bn_bwd_partials_plain(x4, g4, a, b)
        numel, isz, gc = x4.numel(), x4.element_size(), gsz * c
        # (name, kernel, plain version, their inputs, the sums' count (a
        # pair of sums, compared as means) or None (an output like x, then
        # (G, C) or (C,) vectors), bytes, operations)
        passes = (
            ("bn_moments", bn_ops.bn_moments, bn_ops.bn_moments_plain,
             (x4,), m, numel * isz + 2 * gc * 4, 3 * numel),
            ("bn_normalize", bn_ops.bn_normalize, bn_ops.bn_normalize_plain,
             (x4, s_p, q_p, m, scale, bias), None,
             2 * numel * isz + 7 * gc * 4 + 2 * c * 4, 8 * numel),
            ("bn_bwd_partials", bn_ops.bn_bwd_partials,
             bn_ops.bn_bwd_partials_plain, (x4, g4, a, b), m,
             2 * numel * isz + 4 * gc * 4, 16 * numel),
            ("bn_dx", bn_ops.bn_dx, bn_ops.bn_dx_plain,
             (x4, g4, sdz_p, sdzx_p, m, a, b, mean, invstd), None,
             3 * numel * isz + 6 * gc * 4 + 2 * c * 4, 18 * numel))
        lib = library_calls(x4, g4, scale, bias) if timed else {}
        case = f"{layer}: x ({gsz}, {n}, {c}, {sp}) {str(dt).split('.')[-1]}"
        for name, kern, plain, args, per, nbytes, nops in passes:
            got, want = kern(*args), plain(*args)
            for one, two in zip(got, kern(*args)):
                expect(torch.equal(one, two),
                       f"{name} {layer}: two launches differ")
            if per:
                pairs = [(torch.stack(got) / per, torch.stack(want) / per,
                          BN_SUM_TOL)]
            else:
                pairs = [(got[0], want[0], BN_OUT_TOL[dt])] + [
                    (k, p, BN_SUM_TOL) for k, p in zip(got[1:], want[1:])]
            if name == "bn_dx" and gsz > 3:
                # dscale and dbias over G = 7 or 21 groups: the bound of a
                # reordered f32 sum (GROUP_SUM_RTOL)
                terms = (bn_ops.bn_dx_coeffs(sdz_p, sdzx_p, m, a, mean,
                                             invstd)[0], sdz_p)
                for k, p, t in zip(got[1:], want[1:], terms):
                    limit = (BN_SUM_TOL["atol"]
                             + GROUP_SUM_RTOL * t.abs().sum(0))
                    expect(bool(((k - p).abs() <= limit).all()),
                           f"bn_dx {layer}: group sums apart")
                group_err = max((k.double() - p.double()).abs().max().item()
                                for k, p in zip(got[1:], want[1:]))
                pairs = pairs[:1]
            else:
                group_err = 0.0
            err = group_err
            for k, p, tol in pairs:
                torch.testing.assert_close(k.float(), p.float(), **tol)
                err = max(err, (k.double() - p.double()).abs().max().item())
            row = rows[name]
            row["max_abs_err"] = max(row["max_abs_err"], err)
            if not timed:
                print(f"[kernel] {name} {case}: max_abs_err {err} "
                      f"(checked, not timed)")
                continue
            t_k = device_ms(lambda: kern(*args), flush)
            t_b2b = back_to_back_ms(kern, args, flush)
            t_p = device_ms(lambda: plain(*args), flush)
            t_lib = device_ms(lib[name], flush)
            b_ms, b_by = bound(nbytes, nops, peaks)
            print(f"[kernel] {name} {case}: max_abs_err {err} ms {t_k} "
                  f"back_to_back_ms {t_b2b} plain_ms {t_p} library_ms "
                  f"{t_lib} bound_ms {b_ms} ({b_by}) x{count} per step "
                  f"| {card}")
            if timed == "family":
                row.setdefault("cases", []).append(dict(
                    case=case, ms=t_k, back_to_back_ms=t_b2b, plain_ms=t_p,
                    library_ms=t_lib, bound_ms=b_ms, bound_by=b_by))
                continue
            for route in per_step:
                if route == "fused" and layer in ENC_CONV_BN:
                    continue
                for key, v in zip(keys, (t_k, t_b2b, t_p, t_lib, b_ms)):
                    per_step[route][name][key] += count * v
            if layer == BN_MAIN_LAYER:
                row.update(ms=t_k, back_to_back_ms=t_b2b, plain_ms=t_p,
                           library_ms=t_lib, bound_ms=b_ms, bound_by=b_by,
                           case=case)
    for route, layers in (("fused", 8), ("unfused", 11)):
        for name, v in per_step[route].items():
            print(f"[kernel] {name} per train step, {route} route ({layers}"
                  f" layers): " + " ".join(f"{k} {v[k]}" for k in keys)
                  + f" | {card}")
    return rows


def phase_conv_kernels(dev, card, peaks, flush):
    """conv2d_moments against its plain version at the encoder's three BN'd
    convs, bf16 (the CLI's step) and f32 (--f32), timed, with per-step
    sums; then at vision's three at B=50 (bf16, each x6 a step on the
    fused route). The library yardstick is two calls, F.conv2d then
    torch.var_mean of its output: no one PyTorch call computes the conv
    and its moments."""
    g = torch.Generator(device=dev).manual_seed(2)
    row = {"max_abs_err": 0.0, "cases": []}
    keys = ("ms", "back_to_back_ms", "plain_ms", "library_ms", "bound_ms")

    def one(layer, b, c_in, h, c_out, stride, pad, dt):
        x = (2 * torch.rand((b, c_in, h, h), generator=g,
                            device=dev)).to(dt)
        w = (torch.randn((c_out, c_in, 4, 4), generator=g, device=dev)
             / (16 * c_in) ** 0.5).to(dt)
        y, s, q = convbn.conv2d_moments_fwd(x, w, stride, pad)
        for got, want in zip(convbn.conv2d_moments_fwd(x, w, stride, pad),
                             (y, s, q)):
            expect(torch.equal(got, want), f"conv2d_moments {layer}: two "
                   "launches differ")
        py, ps, pq = convbn.conv2d_moments_plain(x, w, stride, pad)
        torch.testing.assert_close(y.float(), py.float(), **CONV_Y_TOL[dt])
        pixels = y.numel() // c_out
        got, want = torch.stack((s, q)) / pixels, torch.stack(
            (ps, pq)) / pixels
        torch.testing.assert_close(got, want, **CONV_SUM_TOL[dt])
        err = max((y.double() - py.double()).abs().max().item(),
                  (got.double() - want.double()).abs().max().item())
        row["max_abs_err"] = max(row["max_abs_err"], err)
        t_k = device_ms(lambda: convbn.conv2d_moments_fwd(
            x, w, stride, pad), flush)
        t_b2b = back_to_back_ms(convbn.conv2d_moments_fwd,
                                (x, w, stride, pad), flush)
        t_p = device_ms(lambda: convbn.conv2d_moments_plain(
            x, w, stride, pad), flush)
        t_lib = device_ms(lambda: torch.var_mean(F.conv2d(
            x, w, stride=stride, padding=pad), dim=(0, 2, 3),
            correction=0), flush)
        isz = x.element_size()
        nbytes = (x.numel() + w.numel() + y.numel()) * isz + 2 * c_out * 4
        nops = 2 * y.numel() * c_in * 16 + 3 * y.numel()
        b_ms, b_by = bound(nbytes, nops, peaks,
                           peaks[2] if dt == torch.bfloat16 else None)
        case = (f"{layer}: x ({b}, {c_in}, {h}, {h}) -> y ({b}, {c_out}"
                f", {y.shape[2]}, {y.shape[3]}) {str(dt).split('.')[-1]}")
        print(f"[kernel] conv2d_moments {case}: max_abs_err {err} ms "
              f"{t_k} back_to_back_ms {t_b2b} plain_ms {t_p} library_ms "
              f"{t_lib} (F.conv2d + "
              f"torch.var_mean, two calls) bound_ms {b_ms} ({b_by}) | "
              f"{card}")
        out = dict(case=case, ms=t_k, back_to_back_ms=t_b2b, plain_ms=t_p,
                   library_ms=t_lib, bound_ms=b_ms, bound_by=b_by)
        row["cases"].append(out)
        return out

    for dt in (torch.bfloat16, torch.float32):
        per_step = dict.fromkeys(keys, 0.0)
        for layer, *shape in CONV_LAYERS:
            out = one(layer, *shape, dt)
            for key in keys:
                per_step[key] += out[key]
            if (layer, dt) == CONV_MAIN:
                row.update(out)
        print(f"[kernel] conv2d_moments per train step, "
              f"{str(dt).split('.')[-1]} (3 layers): "
              + " ".join(f"{k} {per_step[k]}" for k in keys) + f" | {card}")
    for layer, *shape in VISION_CONV_LAYERS:
        one(layer, *shape, torch.bfloat16)
    return {"conv2d_moments": row}


def library_calls(x4, g4, scale, bias):
    """One PyTorch call (or pair) per BN pass as its yardstick: var_mean
    over (N, S) for the moments; F.batch_norm(training=True) then F.silu,
    per group (two calls a group), for normalize; the autograd backward of
    those calls for both backward passes together."""
    gsz = x4.shape[0]
    xs = [x4[i].detach().clone().requires_grad_(True) for i in range(gsz)]
    w = scale.detach().clone().requires_grad_(True)
    bb = bias.detach().clone().requires_grad_(True)

    def fwd(inputs, weight, b):
        return [F.silu(F.batch_norm(xi, None, None, weight, b, training=True))
                for xi in inputs]

    ys = fwd(xs, w, bb)
    gs = [g4[i] for i in range(gsz)]

    def bwd():
        return torch.autograd.grad(ys, xs + [w, bb], gs, retain_graph=True)

    return {"bn_moments": lambda: torch.var_mean(x4, dim=(1, 3),
                                                 correction=0),
            "bn_normalize": lambda: fwd([x4[i] for i in range(gsz)],
                                        scale, bias),
            "bn_bwd_partials": bwd, "bn_dx": bwd}


def expect(cond, what):
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def check_images(out, n):
    expect(out["image"].shape == (n, 64, 64, 3), f"image {out['image'].shape}")
    expect(out["attrs"].shape == (n, 18), f"attrs {out['attrs'].shape}")
    for k, v in out.items():
        expect(bool(torch.isfinite(v).all()) and v.min() >= 0
               and v.max() <= 1, f"{k} outside [0, 1] or not finite")


def celeba(dtype, dev, seed=0):
    """CelebaMVAE(100) from a seeded generator, with the BN affine
    parameters and running statistics drawn at random too, so eval-mode BN
    does real work (the default init makes it the identity)."""
    model = CelebaMVAE(100, None if dtype == torch.float32 else dtype,
                       device=dev,
                       generator=torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                c = m.weight.shape[0]
                m.running_mean.copy_(0.3 * torch.randn(c, generator=g))
                m.running_var.copy_(0.5 + torch.rand(c, generator=g))
                m.weight.copy_(0.5 + torch.rand(c, generator=g))
                m.bias.copy_(0.1 * torch.randn(c, generator=g))
    return model


def phase_serving(dev, card):
    """Every Sampler endpoint on CelebaMVAE(100) in bf16."""
    sampler = Sampler(celeba(torch.bfloat16, dev), device=dev)
    t0 = time.perf_counter()
    sampler.warmup(buckets=(1, 64))
    torch.cuda.synchronize()
    print(f"[serve] warmup buckets (1, 64): {time.perf_counter() - t0} s"
          f" | {card}")

    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.random((64, 64, 64, 3), np.float32)).to(dev)
    attrs = torch.from_numpy((rng.random((64, 18)) < 0.3)
                             .astype(np.float32)).to(dev)

    out = sampler.sample(n=64, seed=0)
    check_images(out, 64)
    expect(torch.equal(sampler.sample(n=64, seed=0)["image"], out["image"]),
           "prior sampling is not deterministic per seed")
    expect(not torch.equal(sampler.sample(n=64, seed=1)["image"],
                           out["image"]), "two seeds gave one draw")
    cond = sampler.sample(n=3, condition={"attrs": attrs[:1]}, seed=0)
    check_images(cond, 3)
    expect(torch.equal(
        sampler.sample(n=3, condition={"attrs": attrs[:1]}, seed=0)["image"],
        cond["image"]), "conditional sampling is not deterministic per seed")
    for names in (("image",), ("attrs",), ("image", "attrs")):
        inputs = {"image": images, "attrs": attrs}
        inputs = {k: inputs[k] for k in names}
        mu, lv = sampler.embed(inputs)
        expect(mu.shape == lv.shape == (64, 100), f"embed {mu.shape}")
        expect(bool(torch.isfinite(mu).all() and torch.isfinite(lv).all()),
               "embed not finite")
        mu37, _ = sampler.embed({k: v[:37] for k, v in inputs.items()})
        expect(torch.equal(sampler.embed(inputs)[0], mu),
               "embed is not deterministic")
        # 37 rows pad to bucket 64 by repeating row 0; padding never leaks
        torch.testing.assert_close(mu37, mu[:37], rtol=0, atol=0)
    for n in (1, 37, 64):
        rec = sampler.reconstruct({"image": images[:n]})
        check_images(rec, n)

    endpoints = {
        "sample": lambda n: sampler.sample(n=n, seed=0),
        "sample|attrs": lambda n: sampler.sample(
            n=n, condition={"attrs": attrs[:1]}, seed=0),
        "embed|image": lambda n: sampler.embed({"image": images[:n]}),
        "embed|attrs": lambda n: sampler.embed({"attrs": attrs[:n]}),
        "embed|image,attrs": lambda n: sampler.embed(
            {"image": images[:n], "attrs": attrs[:n]}),
        "reconstruct|image": lambda n: sampler.reconstruct(
            {"image": images[:n]}),
    }
    for name, fn in endpoints.items():
        for n in (1, 64):
            print(f"[serve] {name} n={n}: median {host_ms(lambda: fn(n))} ms"
                  f" | {card}")
    profile_breakdown("serve embed|image n=1",
                      lambda: endpoints["embed|image"](1), card)
    profile_breakdown("serve reconstruct|image n=64",
                      lambda: endpoints["reconstruct|image"](64), card)


# phase 3b: the burst, HTTP_CLIENTS clients x HTTP_REQUESTS one-row /embed
# requests each, at each window (ms) in turns A, B, B, A
HTTP_CLIENTS, HTTP_REQUESTS = 16, 8
HTTP_WINDOWS = (2.0, 0.0)
HTTP_CONDITIONS = (("image",), ("attrs",), ("image", "attrs"))
# a coalesced request may land in another batch bucket than it would alone,
# where cuDNN and cuBLAS may choose other algorithms: its posterior (f32,
# from the bf16 model) is held to the row served alone within this
# relative norm, and bit for bit where the bucket is the same
COALESCED_RTOL = 1e-2


def http(port, method, path, body=None):
    """(status, payload) of one request to the server on 127.0.0.1:port;
    an error status comes back as a status, not an exception."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", method=method,
        data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.load(r)
    except urllib.error.HTTPError as e:
        return e.code, json.load(e)


def served_as_direct(what, out, want):
    """A response's arrays equal the direct Sampler call's bit for bit."""
    got = {k: decode_array(v, np.float32) for k, v in out.items()}
    expect(sorted(got) == sorted(want), f"{what}: keys {sorted(got)}")
    for k, v in want.items():
        w = v.float().cpu().numpy()
        expect(got[k].dtype == np.float32 and got[k].shape == w.shape
               and np.array_equal(got[k], w),
               f"{what} {k}: not the direct call's")


def phase_serving_http(dev, card):
    """Phase 3b: the HTTP front (serve_http.py) around a Sampler of
    CelebaMVAE(100) in bf16 on 127.0.0.1, warmed up at the buckets 1 to
    64 with HTTP_CONDITIONS. Every endpoint in JSON and in the binary
    form against the direct Sampler call (bit for bit: one request alone
    lands in the direct call's bucket), a 400 and a 404, 16 concurrent
    one-row requests each against its row served alone (COALESCED_RTOL);
    then the burst of tools/serve_http_bench.py at the windows of
    HTTP_WINDOWS in turns, which fails unless the 2 ms window coalesces
    (device calls < requests); the servers shut down after each part."""
    sampler = Sampler(celeba(torch.bfloat16, dev), device=dev)
    t0 = time.perf_counter()
    sampler.warmup(buckets=warmup_buckets(64), conditions=HTTP_CONDITIONS)
    torch.cuda.synchronize()
    print(f"[serve_http] warmup, buckets 1-64, conditions {HTTP_CONDITIONS}:"
          f" {time.perf_counter() - t0} s | {card}")
    rng = np.random.default_rng(5)
    rows = {"image": rng.random((HTTP_CLIENTS, 64, 64, 3), np.float32),
            "attrs": (rng.random((HTTP_CLIENTS, 18)) < 0.3).astype(
                np.float32)}
    app = ServeApp(sampler, window_ms=2.0)
    srv = make_server(app, "127.0.0.1", 0)
    port = srv.server_address[1]
    server = threading.Thread(target=srv.serve_forever, daemon=True)
    server.start()
    try:
        status, h = http(port, "GET", "/healthz")
        expect(status == 200 and h["model"] == "CelebaMVAE"
               and h["n_latents"] == 100, f"/healthz {status} {h}")
        for binary in (False, True):
            form = "binary" if binary else "JSON"
            for names in HTTP_CONDITIONS:
                inputs = {k: rows[k][:5] for k in names}
                body = {"inputs": {k: encode_array(v, binary)
                                   for k, v in inputs.items()},
                        "binary": binary}
                for path, direct in (
                        ("/embed", dict(zip(("mu", "logvar"),
                                            sampler.embed(inputs)))),
                        ("/reconstruct", sampler.reconstruct(inputs))):
                    status, out = http(port, "POST", path, body)
                    expect(status == 200, f"{path} {names}: {status} {out}")
                    served_as_direct(f"{path} {names} {form}", out, direct)
            one = {k: v[:1] for k, v in rows.items()}
            for cond, direct in ((None, None),
                                 ({"attrs": one["attrs"]}, None),
                                 ({"attrs": rows["attrs"][0]},
                                  {"attrs": one["attrs"]}),
                                 ({"image": one["image"]}, None)):
                body = {"n": 4, "seed": 3, "binary": binary}
                if cond:
                    body["condition"] = {k: encode_array(v, binary)
                                         for k, v in cond.items()}
                status, out = http(port, "POST", "/sample", body)
                expect(status == 200, f"/sample {cond}: {status} {out}")
                served_as_direct(f"/sample {form}", out, sampler.sample(
                    n=4, seed=3, condition=direct or cond))
        status, out = http(port, "POST", "/embed",
                           {"inputs": {"nope": [[0.0]]}})
        expect(status == 400 and "unknown modality" in out["error"],
               f"a bad modality: {status} {out}")
        expect(http(port, "GET", "/nope")[0] == 404, "GET /nope")
        calls0 = app._batcher.device_calls
        got = [None] * HTTP_CLIENTS

        def hit(i):
            got[i] = http(port, "POST", "/embed", {"inputs": {
                "image": encode_array(rows["image"][i:i + 1], True)},
                "binary": True})

        threads = [threading.Thread(target=hit, args=(i,))
                   for i in range(HTTP_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        calls = app._batcher.device_calls - calls0
        gaps = []
        for i, (status, out) in enumerate(got):
            expect(status == 200, f"concurrent /embed {i}: {status}")
            alone = sampler.embed({"image": rows["image"][i:i + 1]})[0]
            mu = torch.from_numpy(decode_array(out["mu"]))
            gaps.append(float((mu - alone.cpu()).norm() / alone.norm()))
        print(f"[serve_http] {HTTP_CLIENTS} concurrent one-row /embed in "
              f"{calls} device calls (rows a call "
              f"{app._batcher.batch_sizes[-calls:]}): largest relative gap "
              f"to the row served alone {max(gaps)}, {gaps.count(0.0)} bit "
              f"for bit (rtol {COALESCED_RTOL}) | {card}")
        expect(max(gaps) <= COALESCED_RTOL, "coalesced rows apart")
        expect(calls < HTTP_CLIENTS or not any(gaps),
               "rows served alone differ from the direct call")
        status, stats = http(port, "GET", "/stats")
        print(f"[serve_http] every endpoint in JSON and binary equal to "
              f"the direct Sampler call bit for bit; /stats {stats}")
    finally:
        srv.shutdown()
        srv.server_close()
        app.close()
        server.join(timeout=30)
    expect(not server.is_alive(), "the server thread did not stop")
    runs = serve_http_bench.bench(sampler, HTTP_WINDOWS, HTTP_CLIENTS,
                                  HTTP_REQUESTS, 1)
    for r in runs:
        print(f"[serve_http] burst {json.dumps(r)} | {card}")
        if r["window_ms"] > 0:
            expect(r["device_calls"] < r["requests"],
                   f"the {r['window_ms']} ms window did not coalesce")
    for w in HTTP_WINDOWS:
        mine = [r for r in runs if r["window_ms"] == w]
        print(f"[serve_http] window {w} ms, {HTTP_CLIENTS} clients x "
              f"{HTTP_REQUESTS} one-row /embed: requests/s "
              f"{[r['req_per_s'] for r in mine]}, p50 ms "
              f"{[r['p50_ms'] for r in mine]}, p95 ms "
              f"{[r['p95_ms'] for r in mine]}, device calls "
              f"{[r['device_calls'] for r in mine]}, rows a call "
              f"{[r['mean_rows_per_call'] for r in mine]} | {card}")


def eval_data(dev, n_data=None, batch=None):
    """A uint8 CelebA-shaped dataset resident on the card, and one batch of
    row indices into it."""
    n_data, batch = n_data or N_DATA, batch or BATCH
    rng = np.random.default_rng(1)
    data = {"image": torch.from_numpy(rng.integers(
                0, 256, (n_data, 64, 64, 3), dtype=np.uint8)).to(dev),
            "attrs": torch.from_numpy((rng.random((n_data, 18)) < 0.3)
                                      .astype(np.float32)).to(dev)}
    return data, torch.from_numpy(rng.permutation(n_data)[:batch]).to(dev)


def phase_eval(dev, card, models, data, idx):
    """The eval step at full width, bf16 and f32: kernel path and plain
    versions timed in turns, then a device-time breakdown."""
    for dtype, model in models.items():
        step = make_eval_step(model, MASKS, LAMBDAS, device=dev,
                              device_data=True)
        total, per_term = step((data, idx))
        expect(bool(torch.isfinite(per_term).all())
               and per_term.shape == (3,), f"per_term {per_term}")
        dt = str(dtype).split(".")[-1]
        print(f"[eval] {dt} B=100 T=3: total {total.item()} per_term "
              f"{per_term.tolist()}")
        # kernel path and plain versions in turns (K, P, P, K): the host
        # clock of a shared machine drifts
        times = {False: [], True: []}
        for plain in (False, True, True, False):
            with ops.plain_versions() if plain else contextlib.nullcontext():
                times[plain].append(host_ms(lambda: step((data, idx))))
        print(f"[eval] {dt} B=100 T=3 step: median {times[False]} ms "
              f"(plain versions {times[True]} ms) | {card}")
        profile_breakdown(f"eval {dt} B=100 T=3", lambda: step((data, idx)),
                          card)


def train_windows(dev, n_windows):
    """idxs (K, B) of each window on the card: every step a batch of
    distinct rows."""
    rng = np.random.default_rng(3)
    return [torch.from_numpy(np.stack([rng.permutation(N_DATA)[:BATCH]
                                       for _ in range(TRAIN_K)])).to(dev)
            for _ in range(n_windows)]


def running_stats(model):
    return {k: v.clone() for k, v in model.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


def timed_window(multi, data, idxs, betas):
    """(losses of one window, its host ms per step)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    window_losses = multi(data, idxs, betas)
    torch.cuda.synchronize()
    return window_losses, (time.perf_counter() - t0) * 1e3 / TRAIN_K


def pairs_won(a, b):
    """How the turns of A and B went, pair by pair: the i-th A and the
    i-th B ran next to each other."""
    wins = sum(x < y for x, y in zip(a, b))
    ties = sum(x == y for x, y in zip(a, b))
    return (f"{wins} of {len(a)} pairs to the first, "
            f"{len(a) - wins - ties} to the second, {ties} tied")


def phase_train(dev, card, data, out):
    """The train step at full width, bf16 and f32: windows of K=20 steps
    of make_multi_train_step (one loss readback a window), kernel path
    and plain versions in turns after a warm-up pair, then the encoder's
    fused route (conv2d_moments; opt-in) and its unfused route (the
    default) in turns, each from a copy of the trained model, then a
    device-time breakdown per step of each route (on shorter windows: the
    profiler's own work grows with the events it keeps). Beta 1, as after
    the CLI's 20 annealing epochs. Records each window's mean loss and the
    running statistics before training, for the checks."""
    # a warm-up pair, then K, P, P, K (K: kernel path, P: plain); the
    # routes likewise, F, U, U, F (F: fused, U: unfused): one round each,
    # as the kernel path's step over longer windows is tools/bench.py's
    # (phase 6k)
    order = (False, True) + (False, True, True, False)
    route_order = (False, True) + (False, True, True, False)
    for dtype in (torch.bfloat16, torch.float32):
        dt = str(dtype).split(".")[-1]
        model = celeba(dtype, dev, seed=10)
        stats0 = running_stats(model)
        multi = make_multi_train_step(
            model, MASKS, LAMBDAS, lr=LR, device=dev,
            generator=torch.Generator(device=dev).manual_seed(0))
        betas = torch.ones(TRAIN_K, device=dev)
        windows = iter(train_windows(dev, len(order) + len(route_order)
                                     + 6))
        losses, times = [], {False: [], True: []}
        for i, plain in enumerate(order):
            with ops.plain_versions() if plain else contextlib.nullcontext():
                window_losses, ms = timed_window(multi, data, next(windows),
                                                 betas)
            losses.append(window_losses.mean().item())
            expect(bool(torch.isfinite(window_losses).all()),
                   f"train {dt}: loss not finite {window_losses}")
            if i >= 2:
                times[plain].append(ms)
        print(f"[train] {dt} B=100 T=3 K={TRAIN_K}: mean loss per window "
              f"{losses} (K, P | K, P, P, K)")
        print(f"[train] {dt} B=100 T=3 step: {times[False]} ms (plain "
              f"versions {times[True]} ms), host clock per window / K; "
              f"{pairs_won(times[False], times[True])} | {card}")

        routes = {}
        for fused in (True, False):
            m = copy.deepcopy(model)
            m.image_encoder.features.conv_moments = fused
            routes[fused] = make_multi_train_step(
                m, MASKS, LAMBDAS, lr=LR, device=dev,
                generator=torch.Generator(device=dev).manual_seed(1))
        r_times = {True: [], False: []}
        for i, unfused in enumerate(route_order):
            window_losses, ms = timed_window(routes[not unfused], data,
                                             next(windows), betas)
            expect(bool(torch.isfinite(window_losses).all()),
                   f"train {dt} route: loss not finite {window_losses}")
            if i >= 2:
                r_times[not unfused].append(ms)
        print(f"[train] {dt} B=100 T=3 step, encoder route: fused "
              f"(conv2d_moments) {r_times[True]} ms, unfused {r_times[False]}"
              f" ms, in turns F, U, U, F, host clock per window "
              f"/ K; fused against unfused: "
              f"{pairs_won(r_times[True], r_times[False])} | {card}")
        for fused, label in ((True, "fused"), (False, "unfused")):
            profile_breakdown(
                f"train {dt} B=100 T=3 step, {label} encoder route (window "
                f"of {PROFILE_K})",
                lambda: routes[fused](data, next(windows)[:PROFILE_K],
                                      betas[:PROFILE_K]), card,
                reps=1, wall_reps=1, per=PROFILE_K)
        out[dtype] = dict(losses=losses, stats0=stats0, model=model)


# phase 5b: the train step's grouped decode (core/engine.py:decode_plan)
# against the one-batch decode that an all-ones recon_support gives: the
# CLIs' bf16 steps at B=100 on CelebA and celeba19 (full width), then the
# launches of MNIST's and MultiMNIST's
GROUPED_TURNS = (True, False) + (True, False, False, True)


def grouped_family(family, dev):
    """(model, T, recon_support of the grouped step, a window's terms(k)
    -> make_multi_train_step's per-step masks and lambdas, or {}) of a
    family's CLI step, bf16, random weights from a seed."""
    if family == "celeba":
        return (celeba(torch.bfloat16, dev, seed=12), len(MASKS),
                static_support(MASKS, LAMBDAS), lambda k: {})
    if family == "celeba19":
        rng = np.random.default_rng(66)

        def terms(k):
            ms, ls = zip(*[c19_terms(rng) for _ in range(k)])
            return {"masks": torch.from_numpy(np.stack(ms)).to(dev),
                    "lambdas": torch.from_numpy(np.stack(ls)).to(dev)}
        return (Celeba19MVAE(100, torch.bfloat16, bf16_loss=True,
                             device=dev,
                             generator=torch.Generator().manual_seed(13)),
                21, celeba19_recon_support(1), terms)
    cls = MnistMVAE if family == "mnist" else MultiMnistMVAE
    return (cls(64, torch.bfloat16, device=dev,
                generator=torch.Generator().manual_seed(14)),
            len(MASKS), static_support(MASKS, MM_LAMBDAS), lambda k: {})


def grouped_rows(family, dev):
    """N_DATA random uint8 rows of MNIST's or MultiMNIST's shapes, resident
    on the card."""
    rng = np.random.default_rng(15)
    shape = (784,) if family == "mnist" else (50, 50, 1)
    text = (N_DATA,) if family == "mnist" else (N_DATA, 4)
    return {"image": torch.from_numpy(rng.integers(
                0, 256, (N_DATA,) + shape, dtype=np.uint8)).to(dev),
            "text": torch.from_numpy(rng.integers(0, 10, text).astype(
                np.int32)).to(dev)}


def grouped_steps(family, dev, model, t, support, one=False):
    """make_train_step (one=True) or make_multi_train_step of the family's
    CLI step on `model` at recon_support `support`."""
    make = make_train_step if one else make_multi_train_step
    kw = dict(device_data=True) if one else {}
    static = family in ("celeba", "mnist", "multimnist")
    lambdas = LAMBDAS if family == "celeba" else MM_LAMBDAS
    return make(model, MASKS if static else None,
                lambdas if static else None, lr=LR, device=dev,
                generator=torch.Generator(device=dev).manual_seed(16),
                recon_support=support, **kw)


def grouped_check(dev, card, family, data, idx):
    """One step of the grouped decode and one of the one-batch decode from
    the same weights and noise: per-term loss above its floor at
    STEP_RTOL, every gradient at GRAD_RTOL, the running statistics after
    at EMA_TOL (bf16); FlopCounterMode's count of a step of each equal to
    the count from shapes, flops_per_step plus the dead work
    (tools/measure.py:count_step: on the grouped step the forward of the
    BN'd decoders' dead terms, on the one batch every dead decode with
    its backward), exactly; the port kernels' launches a step."""
    model, t, support, terms = grouped_family(family, dev)
    twin = copy.deepcopy(model)
    ones = np.ones_like(support)
    noise = draw_noise(model, t, BATCH, torch.Generator(
        device=dev).manual_seed(17))
    step_terms = {k: v[0] for k, v in terms(1).items()}
    masks = step_terms.get("masks", torch.tensor(MASKS, device=dev))
    lambdas = step_terms.get("lambdas", torch.tensor(
        LAMBDAS if family == "celeba" else MM_LAMBDAS, device=dev))
    floor = (masks.double().cpu() * lambdas.double().cpu()) @ (
        family_floor(model) if family == "celeba19" else torch.tensor(
            ELEMENTS, dtype=torch.float64) * np.log(2.0))
    out, flops = {}, {}
    for name, m, sup in (("grouped", model, support), ("one batch", twin,
                                                       ones)):
        step = grouped_steps(family, dev, m, t, sup, one=True)
        expect((step.plan is None) == (name == "one batch"),
               f"grouped {family}: the {name} step's plan {step.plan}")
        ops.reset_launch_counts()
        _, per_term = step((data, idx), 1.0, noise, **step_terms)
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        out[name] = (per_term.double().cpu() - floor,
                     {k: p.grad.detach().clone()
                      for k, p in m.named_parameters()},
                     running_stats(m))
        with FlopCounterMode(display=False) as counter:
            step((data, idx), 1.0, noise, **step_terms)
            torch.cuda.synchronize()
        want = measure.count_step(m, masks.cpu().numpy(),
                                  lambdas.cpu().numpy(), BATCH,
                                  recon_support=sup)
        flops[name] = (counter.get_total_flops(), want)
        print(f"[grouped] {family} bf16 B=100 T={t}, {name} decode: "
              f"FlopCounterMode {flops[name][0]} FLOPs a step; from shapes "
              f"flops_per_step {want.needed} + dead work {want.dead}; port "
              f"kernel launches a step {launches} | {card}")
        expect(flops[name][0] == want.needed + want.dead,
               f"grouped {family} {name}: FlopCounterMode counts "
               f"{flops[name][0]}, the shapes {want.needed} + {want.dead}")
    (g_terms, g_grads, g_stats), (o_terms, o_grads, o_stats) = (
        out["grouped"], out["one batch"])
    held(f"grouped {family} bf16 B=100 train step loss above floor, "
         f"grouped vs one batch", g_terms, o_terms,
         STEP_RTOL[torch.bfloat16], 0.0)
    grads_held(f"grouped {family} bf16 B=100 train step, grouped vs one "
               f"batch", g_grads, o_grads, GRAD_RTOL[torch.bfloat16],
               GRAD_NOISE_ATOL[torch.bfloat16], bn_fed_biases(model))
    gap = 0.0
    for k, v in o_stats.items():
        gap = max(gap, (g_stats[k] - v).abs().max().item())
        torch.testing.assert_close(g_stats[k], v, **EMA_TOL[torch.bfloat16])
    print(f"[check] grouped {family} bf16 running statistics after the "
          f"step, grouped vs one batch: {len(o_stats)} tensors, max_abs_err "
          f"{gap} ({EMA_TOL[torch.bfloat16]})")
    expect(flops["grouped"][0] < flops["one batch"][0],
           f"grouped {family}: the grouped step counts more FLOPs")


def grouped_turns(dev, card, family, data):
    """The grouped and the one-batch bf16 step in windows of K=20 steps of
    make_multi_train_step from the same weights, in turns after a warm-up
    pair (G, O | G, O, O, G): host ms a step, the peak device memory of a
    window (what was allocated before included), then a profile line of
    each (device ms, launches and idle share a step)."""
    model, t, support, terms = grouped_family(family, dev)
    multis = {True: grouped_steps(family, dev, model, t, support),
              False: grouped_steps(family, dev, copy.deepcopy(model), t,
                                   np.ones_like(support))}
    betas = torch.ones(TRAIN_K, device=dev)
    windows = iter(train_windows(dev, len(GROUPED_TURNS) + 4))
    times, peaks = {True: [], False: []}, {}
    for i, grouped in enumerate(GROUPED_TURNS):
        kw = terms(TRAIN_K)
        losses, ms = timed_window(lambda *a: multis[grouped](*a, **kw),
                                  data, next(windows), betas)
        expect(bool(torch.isfinite(losses).all()),
               f"grouped {family}: loss not finite {losses}")
        if i >= 2:
            times[grouped].append(ms)
    for grouped in (True, False):
        idxs, kw = next(windows)[:PROFILE_K], terms(PROFILE_K)
        peaks[grouped] = measure.peak_memory_bytes(
            lambda: multis[grouped](data, idxs, betas[:PROFILE_K], **kw),
            dev)
    print(f"[grouped] {family} bf16 B=100 T={t} step, host ms a step (window "
          f"of {TRAIN_K} / K) grouped {times[True]}, one batch "
          f"{times[False]}, in turns G, O, O, G; grouped against one batch: "
          f"{pairs_won(times[True], times[False])}; peak device memory of a "
          f"window of {PROFILE_K}, grouped {peaks[True]} bytes, one batch "
          f"{peaks[False]} bytes | {card}")
    for grouped in (True, False):
        idxs, kw = next(windows)[:PROFILE_K], terms(PROFILE_K)
        profile_breakdown(
            f"{family} bf16 B=100 T={t} train step, "
            f"{'grouped' if grouped else 'one-batch'} decode (window of "
            f"{PROFILE_K})", lambda: multis[grouped](
                data, idxs, betas[:PROFILE_K], **kw), card, reps=1,
            wall_reps=1, per=PROFILE_K)


def phase_grouped(dev, card, data):
    """Phase 5b: the grouped decode against the one-batch decode on the
    CLIs' bf16 steps: CelebA and celeba19 checked (grouped_check) and
    timed in turns (grouped_turns); MNIST's and MultiMNIST's launches a
    step, port kernels and all (a profile line of a window of each)."""
    idx = train_windows(dev, 1)[0][0]
    for family in ("celeba", "celeba19"):
        grouped_check(dev, card, family, data, idx)
        lap(f"grouped: {family} checked")
        grouped_turns(dev, card, family, data)
        lap(f"grouped: {family} in turns")
    for family in ("mnist", "multimnist"):
        rows = grouped_rows(family, dev)
        model, t, support, terms = grouped_family(family, dev)
        twin = copy.deepcopy(model)
        step = grouped_steps(family, dev, model, t, support, one=True)
        ones = grouped_steps(family, dev, twin, t, np.ones_like(support),
                             one=True)
        for name, s in (("grouped", step), ("one batch", ones)):
            ops.reset_launch_counts()
            s((rows, idx), 1.0)
            torch.cuda.synchronize()
            print(f"[grouped] {family} bf16 B=100 T={t}, {name} decode: "
                  f"port kernel launches a step {ops.launch_counts()} | "
                  f"{card}")
        for multi_model, sup, name in ((model, support, "grouped"),
                                       (twin, np.ones_like(support),
                                        "one-batch")):
            multi = grouped_steps(family, dev, multi_model, t, sup)
            idxs = train_windows(dev, 1)[0][:PROFILE_K]
            profile_breakdown(
                f"{family} bf16 B=100 T={t} train step, {name} decode "
                f"(window of {PROFILE_K})", lambda: multi(
                    rows, idxs, torch.ones(PROFILE_K, device=dev)), card,
                reps=1, wall_reps=1, per=PROFILE_K)


# the reference's log lines (train/loop.py:log_train, log_epoch, log_test)
# and the driver's throughput line
LOG_LINE = re.compile(
    r"^(Train Epoch: \d+ \[\d+/\d+ \(\d+%\)\]\tLoss: -?\d+\.\d{6}\t"
    r"Annealing-Factor: \d\.\d{3}|====> Epoch: \d+\tLoss: -?\d+\.\d{4}"
    r"|====> Test Loss: -?\d+\.\d{4}|====> Throughput: \d+\.\d{2} "
    r"steps/sec)$")


def run_train_cli(main, argv, first_extra, out_dir, what, real_data=False,
                  resume_extra=()):
    """A train CLI's main for CLI_EPOCHS epochs (with first_extra), then
    --resume of its checkpoint for one more (with resume_extra), on the
    card. Checks the reference's log lines (two train lines an epoch: 20
    steps, windows of 10), both files, the epoch the resume starts at and
    a finite test loss each epoch, and with real_data that the loader read
    files (no synthetic fallback). Returns (test losses, throughput lines,
    each epoch's training wall s, the resumed run's lines)."""
    rec = TimedLines(sys.stdout)
    with contextlib.redirect_stdout(rec):
        rec.lines.append((time.perf_counter(), f"[{what}] start"))
        main(argv + ["--epochs", str(CLI_EPOCHS)] + first_extra)
        rec.lines.append((time.perf_counter(), f"[{what}] resume"))
        main(argv + ["--epochs", str(CLI_EPOCHS + 1), "--resume",
                     os.path.join(out_dir, CKPT), *resume_extra])
    for name in (CKPT, BEST):
        expect(os.path.isfile(os.path.join(out_dir, name)),
               f"{what}: no {name}")
    lines = [line for _, line in rec.lines]
    expect(not (real_data and any("synthetic fallback" in line
                                  for line in lines)),
           f"{what}: the loader fell back to synthetic data")
    logs = [line for line in lines if LOG_LINE.match(line)]
    epochs = list(range(1, CLI_EPOCHS + 2))
    for e in epochs:
        expect(sum(line.startswith(f"Train Epoch: {e} [") for line in
                   logs) == 2, f"{what}: epoch {e} has not 2 train lines")
        expect(f"====> Epoch: {e}\t" in "\n".join(logs),
               f"{what}: no epoch line for epoch {e}")
    tests = [float(line.split()[-1]) for line in logs
             if line.startswith("====> Test Loss")]
    expect(len(tests) == len(epochs) and all(np.isfinite(tests)),
           f"{what}: test losses {tests}")
    i = lines.index(f"[{what}] resume")
    expect(any(line.startswith("resumed from ") and
               line.endswith(f"at epoch {CLI_EPOCHS}")
               for line in lines[i:]), f"{what}: no resume line")
    first = next(line for line in lines[i:]
                 if line.startswith("Train Epoch"))
    expect(first.startswith(f"Train Epoch: {CLI_EPOCHS + 1} [0/"),
           f"{what}: resumed at {first!r}")
    throughput = [line for line in logs if "Throughput" in line]
    expect(len(throughput) == CLI_EPOCHS - 1, f"{what}: throughput lines")
    # an epoch's training: from the line before its first train line
    # (the pipeline line or the last epoch's test loss) to its epoch line
    train_s, start = [], None
    for t, line in rec.lines:
        if line.startswith(("input pipeline", "====> Test Loss")):
            start = t
        elif line.startswith("====> Epoch"):
            train_s.append(t - start)
    return tests, throughput, train_s, lines[i:]


def phase_cli(dev, card, root):
    """The training CLI on the card: experiments/celeba/train.py:main on
    the synthetic CelebA set (2000 train and 500 val rows, the loader's
    defaults), CelebaMVAE(100) in bf16 (the CLI's defaults), CLI_EPOCHS
    epochs on the fused route (--conv-moments: the path of
    conv2d_moments), annealing 1, windows of 10; then --resume of its
    checkpoint for one more epoch on the default, unfused route; then
    model_best.pth.tar served by Sampler. Checks
    the log lines, the files, the epoch the resume starts at, and a
    finite test loss; prints the throughput and each epoch's wall time.
    The run's files stay under root/celeba for phase 6c; returns the
    checkpoint directory."""
    tmp = os.path.join(root, "celeba")
    out_dir = os.path.join(tmp, "models")
    argv = ["--annealing-epochs", "1", "--log-interval", "10",
            "--out-dir", out_dir, "--data-dir", os.path.join(tmp, "data")]
    tests, throughput, train_s, _ = run_train_cli(
        celeba_cli.main, argv, ["--conv-moments"], out_dir, "cli",
        resume_extra=["--profile-dir", os.path.join(tmp, "trace")])
    epochs = list(range(1, CLI_EPOCHS + 2))
    print(f"[cli] CelebaMVAE(100) bf16 B=100, 20 steps an epoch: "
          f"{throughput} ; epoch training wall s {train_s} (epochs "
          f"{epochs}; epoch 1 and the resumed epoch {CLI_EPOCHS + 1} "
          f"include the warm-up) | {card}")

    sampler = Sampler.from_checkpoint(os.path.join(out_dir, BEST),
                                      compute_dtype=torch.bfloat16)
    images = torch.rand((8, 64, 64, 3), device=dev,
                        generator=torch.Generator(device=dev)
                        .manual_seed(7))
    check_images(sampler.reconstruct({"image": images}), 8)
    print(f"[cli] {BEST} served one reconstruct request of 8 rows; test "
          f"losses {tests}")
    return out_dir


# the MNIST families' CLIs (phase 6c): train, sample, loglike modules, the
# model class and the IDX variant
FAMILY_CLIS = {
    "mnist": (mnist_train, mnist_sample, mnist_loglike, MnistMVAE, "MNIST"),
    "fashionmnist": (fashion_train, fashion_sample, fashion_loglike,
                     FashionMnistMVAE, "FashionMNIST"),
}
N_FAM_TRAIN, N_FAM_TEST = 2000, 500   # rows of the IDX sets phase 6c writes
FAM_LAMBDAS = [[1.0, 10.0]] * 3       # experiments/mnist/train.py defaults
FAM_LR = 1e-3
IWAE_K = 100                          # the loglike CLIs' default K
# the IWAE estimate, kernel path vs plain versions on the card (f32): the
# BCE kernel's softplus from ex2.approx / lg2.approx is within 6.7e-7 of
# the precise one an element (8.2e-3 over a CelebA row of 12288, PERF.md
# section 6), against estimates of 500-9000 in magnitude; the rest sums in
# another order
IWAE_TOL = dict(rtol=1e-5, atol=0.0)


def write_idx_set(root, variant):
    """N_FAM_TRAIN train and N_FAM_TEST test rows of the synthetic digits
    as the IDX files the loader reads (root/variant/raw)."""
    raw = os.path.join(root, variant, "raw")
    os.makedirs(raw)
    for stem, n, seed in (("train", N_FAM_TRAIN, 0), ("t10k", N_FAM_TEST, 1)):
        images, labels = synthetic_mnist(n, seed=seed)
        write_idx(os.path.join(raw, f"{stem}-images-idx3-ubyte"),
                  np.round(images * 255))
        write_idx(os.path.join(raw, f"{stem}-labels-idx1-ubyte"), labels)


def run_main(main, argv):
    """(main(argv)'s value, its stdout lines); the text passes on."""
    rec = TimedLines(sys.stdout)
    with contextlib.redirect_stdout(rec):
        value = main(argv)
    return value, [line for _, line in rec.lines]


def check_family_outputs(out, n, family):
    """Sampler outputs of an MNIST family: n images in [0, 1], n rows of
    10 class probabilities that sum to 1."""
    shape = (784,) if family == "mnist" else (28, 28, 1)
    expect(tuple(out["image"].shape) == (n,) + shape,
           f"{family} image {tuple(out['image'].shape)}")
    expect(tuple(out["text"].shape) == (n, 10),
           f"{family} text {tuple(out['text'].shape)}")
    for k, v in out.items():
        expect(bool(torch.isfinite(v).all()) and v.min() >= 0
               and v.max() <= 1, f"{family} {k} outside [0, 1]")
    torch.testing.assert_close(out["text"].sum(-1),
                               torch.ones(n, device=out["text"].device),
                               rtol=1e-5, atol=1e-5)


def family_device_data(family, data_dir, dev):
    """The family's IDX train set resident on the card, as the driver
    keeps it (MNIST's flat rows f32, FashionMNIST's images uint8)."""
    variant = FAMILY_CLIS[family][4]
    ds = load_mnist(data_dir, train=True, variant=variant,
                    flatten=family == "mnist", synthetic_ok=False)
    return to_device_data(ds, dev)


def family_train_timing(dev, card, family, data):
    """The family's bf16 train step at B=100, with its profile line
    (profiled_window); for fashionmnist also what the convergence
    runner's cuDNN flags cost it (determinism_readings)."""
    model = FAMILY_CLIS[family][3](
        64, torch.bfloat16, device=dev,
        generator=torch.Generator().manual_seed(40))
    multi = make_multi_train_step(
        model, MASKS, FAM_LAMBDAS, lr=FAM_LR, device=dev,
        generator=torch.Generator(device=dev).manual_seed(41))
    profiled_window(dev, card, f"{family} T=3", multi, data, lambda k: {})
    if family == "fashionmnist":
        determinism_readings(dev, card, family, multi, data)


def iwae_inputs(family, dev, data_dir):
    """(f32 model of the family, the first BATCH test rows on the card,
    eps (IWAE_K, BATCH, D) from a seeded generator on the card)."""
    if family == "celeba":
        model = celeba(torch.float32, dev, seed=50)
        test = load_celeba(data_dir, "test").arrays
    elif family == "celeba19":
        model = Celeba19MVAE(100, device=dev,
                             generator=torch.Generator().manual_seed(50))
        test = load_celeba(data_dir, "test").arrays
    elif family == "multimnist":
        model = MultiMnistMVAE(64, device=dev,
                               generator=torch.Generator().manual_seed(50))
        test = load_multimnist(data_dir, train=False).arrays
    else:
        model = FAMILY_CLIS[family][3](
            64, device=dev, generator=torch.Generator().manual_seed(50))
        test = load_mnist(data_dir, train=False,
                          variant=FAMILY_CLIS[family][4],
                          flatten=family == "mnist",
                          synthetic_ok=False).arrays
    batch = {k: torch.from_numpy(v[:BATCH]).to(dev) for k, v in test.items()}
    eps = torch.randn((IWAE_K, BATCH, model.n_latents), device=dev,
                      generator=torch.Generator(device=dev).manual_seed(51))
    return model, batch, eps


def phase_families(dev, card, root, celeba_dir):
    """Phase 6c: the MNIST families end to end on the card, and the CelebA
    sample and loglike CLIs at full width. For MNIST and FashionMNIST: an
    IDX set of the synthetic digits (N_FAM_TRAIN train, N_FAM_TEST test
    rows); the train CLI with its shipped defaults (bf16, L=64, batch 100,
    lr 1e-3) for CLI_EPOCHS epochs, then --resume for one more (the checks
    of phase 6b); the sample CLI in its four modes from model_best.pth.tar;
    the loglike CLI at K=100 on the N_FAM_TEST test rows for image, text
    and joint (finite, negative); Sampler.from_checkpoint answering one
    request at every endpoint; the bf16 train step's profile line
    (profiled_window); the profile line of one
    IWAE batch (K=100, B=100, f32). Then CelebaMVAE(100) from phase 6b's
    checkpoint: the loglike CLI (joint, K=100, the CelebA loader's test
    partition: 500 synthetic rows), the sample CLI with --condition-on-attrs, and its IWAE batch's
    profile line. Returns {family: its data directory}."""
    dirs = {"celeba": os.path.join(root, "celeba", "data")}
    for family, (train, sample, loglike_cli, cls, variant) in \
            FAMILY_CLIS.items():
        tmp = os.path.join(root, family)
        data_dir, out_dir = (os.path.join(tmp, d) for d in ("data", "models"))
        dirs[family] = data_dir
        write_idx_set(data_dir, variant)
        t0 = time.perf_counter()
        tests, throughput, train_s, _ = run_train_cli(
            train.main, ["--out-dir", out_dir, "--data-dir", data_dir], [],
            out_dir, family, real_data=True)
        print(f"[{family}] {cls.__name__}(64) bf16 B=100, 20 steps an "
              f"epoch: {throughput} ; epoch training wall s {train_s}; test "
              f"losses {tests}; the CLI runs {time.perf_counter() - t0} s "
              f"| {card}")
        best = os.path.join(out_dir, BEST)

        label = int(load_mnist(data_dir, train=False, variant=variant,
                               synthetic_ok=False).arrays["text"][0])
        t0 = time.perf_counter()
        for i, extra in enumerate((
                [], ["--condition-on-image", str(label)],
                ["--condition-on-text", str(label)],
                ["--condition-on-image", str(label), "--condition-on-text",
                 str(label)])):
            d = os.path.join(tmp, f"samples{i}")
            out, _ = run_main(sample.main, [best, "--out-dir", d,
                                            "--data-dir", data_dir] + extra)
            check_family_outputs(out, 64, family)
            with open(os.path.join(d, "sample_image.png"), "rb") as f:
                expect(f.read(8) == b"\x89PNG\r\n\x1a\n",
                       f"{family} sample {extra}: not a PNG")
            with open(os.path.join(d, "sample_text.txt")) as f:
                lines = f.read().splitlines()
            expect(len(lines) == 64 and lines[63].startswith("Text (63): "),
                   f"{family} sample {extra}: {len(lines)} text lines")
        print(f"[{family}] sample CLI, four modes of 64 samples: "
              f"{time.perf_counter() - t0} s | {card}")

        for target in ("image", "text", "joint"):
            run_loglike_cli(loglike_cli.main, best, data_dir, target,
                            N_FAM_TEST, family, card)

        sampler = Sampler.from_checkpoint(best)
        expect(type(sampler.model) is cls, f"{family}: served "
               f"{type(sampler.model).__name__}")
        test = load_mnist(data_dir, train=False, variant=variant,
                          flatten=family == "mnist", synthetic_ok=False)
        images = torch.from_numpy(test.arrays["image"][:8]).to(dev)
        labels = torch.from_numpy(test.arrays["text"][:8]).to(dev)
        check_family_outputs(sampler.sample(n=8, seed=0), 8, family)
        for cond in ({"image": images[:1]}, {"text": labels[:1]}):
            check_family_outputs(sampler.sample(n=8, condition=cond), 8,
                                 family)
        for inputs in ({"image": images}, {"text": labels},
                       {"image": images, "text": labels}):
            mu, lv = sampler.embed(inputs)
            expect(mu.shape == lv.shape == (8, 64) and bool(
                torch.isfinite(mu).all() and torch.isfinite(lv).all()),
                f"{family} embed {sorted(inputs)}")
            if len(inputs) == 1:
                check_family_outputs(sampler.reconstruct(inputs), 8, family)
        print(f"[{family}] {BEST} served every endpoint (sample, sample|"
              f"image, sample|text, embed and reconstruct)")

        family_train_timing(dev, card, family,
                            family_device_data(family, data_dir, dev))
        model, batch, eps = iwae_inputs(family, dev, data_dir)
        profile_breakdown(
            f"{family} IWAE f32 K={IWAE_K} B={BATCH} joint",
            lambda: iwae_log_marginal(model, batch, [1.0, 1.0],
                                      list(model.modalities), IWAE_K,
                                      eps=eps), card)

    best = os.path.join(celeba_dir, BEST)
    run_loglike_cli(celeba_loglike.main, best, dirs["celeba"], "joint",
                    len(load_celeba(dirs["celeba"], "test")), "celeba", card)
    d = os.path.join(root, "celeba", "samples")
    out, _ = run_main(celeba_sample.main, [
        best, "--condition-on-attrs", "Smiling", "--out-dir", d,
        "--data-dir", dirs["celeba"]])
    check_images(out, 64)
    with open(os.path.join(d, "sample_attrs.txt")) as f:
        expect(len(f.read().splitlines()) == 64, "celeba sample_attrs.txt")
    model, batch, eps = iwae_inputs("celeba", dev, dirs["celeba"])
    profile_breakdown(
        f"celeba IWAE f32 K={IWAE_K} B={BATCH} joint",
        lambda: iwae_log_marginal(model, batch, [1.0, 1.0],
                                  list(model.modalities), IWAE_K, eps=eps),
        card, reps=2, wall_reps=3)
    return dirs


def phase_iwae_checks(dev, dirs):
    """The IWAE estimate on the card against references, with one eps:
    the kernel path against the plain versions (MNIST and CelebA at
    K=100, B=100, IWAE_TOL), and the card against the CPU in f32 (MNIST
    at K=100, B=100; CelebA at K=8, B=4: CARD_TOL)."""
    for family in ("mnist", "celeba"):
        model, batch, eps = iwae_inputs(family, dev, dirs[family])
        names = list(model.modalities)
        got = iwae_log_marginal(model, batch, [1.0, 1.0], names, IWAE_K,
                                eps=eps)
        with ops.plain_versions():
            want = iwae_log_marginal(model, batch, [1.0, 1.0], names,
                                     IWAE_K, eps=eps)
        held(f"{family} IWAE f32 K={IWAE_K} B={BATCH} joint, kernels vs "
             f"plain (mean {got.mean().item()})", got, want, **IWAE_TOL)
        k, b = (IWAE_K, BATCH) if family == "mnist" else (8, 4)
        cpu = copy.deepcopy(model).cpu()
        want = iwae_log_marginal(cpu, {n: v[:b].cpu() for n, v in
                                       batch.items()}, [1.0, 1.0], names, k,
                                 eps=eps[:k, :b].cpu())
        got = iwae_log_marginal(model, {n: v[:b] for n, v in batch.items()},
                                [1.0, 1.0], names, k, eps=eps[:k, :b])
        held(f"{family} IWAE f32 K={k} B={b} joint, card vs CPU", got, want,
             **CARD_TOL)


# --------------------------------------------------------------------------
# phases 6d and 6e: the MultiMNIST and celeba19 families
# --------------------------------------------------------------------------

N_MM_TRAIN, N_MM_TEST = 2000, 500     # rows of the shards phase 6d writes
MM_LAMBDAS = [[1.0, 10.0]] * 3        # experiments/multimnist/train.py
C19_LAMBDAS = (1.0, 10.0)             # experiments/celeba19/train.py


def c19_terms(rng):
    """One celeba19 step's (21, 19) masks and lambdas (--approx-m 1)."""
    return celeba19_step_terms(rng, 1, 18, *C19_LAMBDAS)


def check_mm_outputs(out, n):
    """Sampler outputs of MultiMNIST: n 50x50 images in [0, 1], n rows of
    4 positions' 12 character probabilities that sum to 1."""
    expect(tuple(out["image"].shape) == (n, 50, 50, 1),
           f"multimnist image {tuple(out['image'].shape)}")
    expect(tuple(out["text"].shape) == (n, 4, 12),
           f"multimnist text {tuple(out['text'].shape)}")
    for k, v in out.items():
        expect(bool(torch.isfinite(v).all()) and v.min() >= 0
               and v.max() <= 1, f"multimnist {k} outside [0, 1]")
    torch.testing.assert_close(out["text"].sum(-1), torch.ones(
        (n, 4), device=out["text"].device), rtol=1e-5, atol=1e-5)


def ab_turns(dev, name, a, b, data, batch=BATCH):
    """Windows of TRAIN_K train steps at B=batch of two variants in turns
    after a warm-up pair (A, B | A, B, B, A); a and b are
    (label, multi, context factory): make_multi_train_step's window run
    inside the context. Returns ({label: host ms per step of each timed
    window}, the mean loss of every window)."""
    rng = np.random.default_rng(42)
    n = next(iter(data.values())).shape[0]

    def window(k):
        return torch.from_numpy(np.stack([rng.permutation(n)[:batch]
                                          for _ in range(k)])).to(dev)

    betas = torch.ones(TRAIN_K, device=dev)
    order = (a, b) + (a, b, b, a)
    losses, times = [], {a[0]: [], b[0]: []}
    for i, (label, multi, context) in enumerate(order):
        torch.cuda.synchronize()
        with context():
            t0 = time.perf_counter()
            window_losses = multi(data, window(TRAIN_K), betas)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3 / TRAIN_K
        expect(bool(torch.isfinite(window_losses).all()),
               f"{name} {label}: loss not finite {window_losses}")
        losses.append(window_losses.mean().item())
        if i >= 2:
            times[label].append(ms)
    return times, losses


def profiled_window(dev, card, name, multi, data, steps_extra,
                    batch=BATCH):
    """A family's bf16 train step at B=batch on the kernel path: windows
    of PROFILE_K steps of make_multi_train_step under a device-time
    breakdown per step (profile_breakdown), every window's losses finite.
    steps_extra(k): the window's extra arguments (celeba19's masks). The
    step's time over longer windows is tools/bench_families.py's (phase
    6k)."""
    rng = np.random.default_rng(43)
    n = next(iter(data.values())).shape[0]
    idxs = torch.from_numpy(np.stack([rng.permutation(n)[:batch]
                                      for _ in range(PROFILE_K)])).to(dev)
    betas = torch.ones(PROFILE_K, device=dev)
    extra = steps_extra(PROFILE_K)
    losses = []
    profile_breakdown(
        f"{name} train bf16 B={batch} step (window of {PROFILE_K})",
        lambda: losses.append(multi(data, idxs, betas, **extra)), card,
        reps=1, wall_reps=1, per=PROFILE_K)
    expect(all(bool(torch.isfinite(x).all()) for x in losses),
           f"{name}: a window's loss is not finite {losses}")


@contextlib.contextmanager
def cudnn_deterministic():
    """cuDNN as the convergence runner sets it (tools/parity_convergence.py:
    run_row): deterministic algorithms, no benchmark; restored after."""
    cudnn = torch.backends.cudnn
    old = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        yield
    finally:
        cudnn.deterministic, cudnn.benchmark = old


def determinism_readings(dev, card, name, multi, data, batch=BATCH):
    """What the convergence runner's cuDNN flags cost a bf16 train step:
    windows with cuDNN's defaults and with cudnn_deterministic in turns
    (ab_turns); then one window under
    torch.use_deterministic_algorithms(True, warn_only=True), whose
    warnings name every op of the step that has no deterministic form."""
    times, _ = ab_turns(
        dev, name, ("cuDNN defaults", multi, contextlib.nullcontext),
        ("cudnn.deterministic", multi, cudnn_deterministic), data, batch)
    a, b = times["cuDNN defaults"], times["cudnn.deterministic"]
    print(f"[determinism] {name} bf16 B={batch} step: cuDNN defaults {a} "
          f"ms, cudnn.deterministic {b} ms (median "
          f"{statistics.median(b) / statistics.median(a)} times), host "
          f"clock per window / K; {pairs_won(a, b)} | {card}")
    rng = np.random.default_rng(44)
    n = next(iter(data.values())).shape[0]
    idxs = torch.from_numpy(np.stack([rng.permutation(n)[:batch]
                                      for _ in range(2)])).to(dev)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            multi(data, idxs, torch.ones(2, device=dev))
            torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(False)
    found = sorted({str(w.message).splitlines()[0][:200] for w in caught})
    print(f"[determinism] {name}: a window under "
          f"use_deterministic_algorithms(warn_only=True) warned of "
          f"{len(found)} ops: {found}")


def run_loglike_cli(main, best, data_dir, target, n_test, what, card):
    t0 = time.perf_counter()
    ll, lines = run_main(main, [best, "--target", target, "--data-dir",
                                data_dir])
    expect(bool(np.isfinite(ll)) and ll < 0, f"{what} log p({target}) = {ll}")
    expect(any(line.startswith(f"====> log p({target}) >= ") and
               line.endswith(f"(K={IWAE_K}, N={n_test})") for line in lines),
           f"{what} loglike line")
    print(f"[{what}] loglike CLI {target}: {ll} in "
          f"{time.perf_counter() - t0} s | {card}")


def phase_multimnist(dev, card, root):
    """Phase 6d: MultiMNIST end to end on the card. Shards of N_MM_TRAIN /
    N_MM_TEST rows from the synthetic digits (the numpy generator); the
    train CLI with its shipped defaults (bf16, L=64, batch 100, lr 1e-3)
    for CLI_EPOCHS epochs, then --resume for one more; the sample CLI from
    the prior, a digit string, a test image of it and both; the loglike CLI
    at K=100 for image, text and joint; Sampler.from_checkpoint at every
    endpoint; the bf16 train step's profile line (profiled_window); one
    IWAE batch's profile line. Returns the data
    directory."""
    tmp = os.path.join(root, "multimnist")
    data_dir, out_dir = (os.path.join(tmp, d) for d in ("data", "models"))
    t0 = time.perf_counter()
    make_dataset(data_dir, n_train=N_MM_TRAIN, n_test=N_MM_TEST)
    print(f"[multimnist] shards of {N_MM_TRAIN} / {N_MM_TEST} rows written in "
          f"{time.perf_counter() - t0} s (numpy generator, host)")
    t0 = time.perf_counter()
    tests, throughput, train_s, _ = run_train_cli(
        mm_train.main, ["--out-dir", out_dir, "--data-dir", data_dir], [],
        out_dir, "multimnist")
    print(f"[multimnist] MultiMnistMVAE(64) bf16 B=100, 20 steps an epoch: "
          f"{throughput} ; epoch training wall s {train_s}; test losses "
          f"{tests}; the CLI runs {time.perf_counter() - t0} s | {card}")
    best = os.path.join(out_dir, BEST)

    test = load_multimnist(data_dir, train=False)
    text = decode_tokens(test.arrays["text"][0])
    t0 = time.perf_counter()
    for i, extra in enumerate(([], ["--condition-on-text", text],
                               ["--condition-on-image", text],
                               ["--condition-on-image", text,
                                "--condition-on-text", text])):
        d = os.path.join(tmp, f"samples{i}")
        out, _ = run_main(mm_sample.main, [best, "--out-dir", d,
                                           "--data-dir", data_dir] + extra)
        check_mm_outputs(out, 64)
        with open(os.path.join(d, "sample_image.png"), "rb") as f:
            expect(f.read(8) == b"\x89PNG\r\n\x1a\n",
                   f"multimnist sample {extra}: not a PNG")
        with open(os.path.join(d, "sample_text.txt")) as f:
            lines = f.read().splitlines()
        expect(len(lines) == 64 and lines[63].startswith("Text (63): "),
               f"multimnist sample {extra}: {len(lines)} text lines")
    print(f"[multimnist] sample CLI, four modes of 64 samples (string "
          f"{text!r}): {time.perf_counter() - t0} s | {card}")
    for target in ("image", "text", "joint"):
        run_loglike_cli(mm_loglike.main, best, data_dir, target, N_MM_TEST,
                        "multimnist", card)

    sampler = Sampler.from_checkpoint(best)
    expect(type(sampler.model) is MultiMnistMVAE, "multimnist: served "
           f"{type(sampler.model).__name__}")
    images = torch.from_numpy(test.arrays["image"][:8]).to(dev)
    texts = torch.from_numpy(test.arrays["text"][:8]).to(dev)
    check_mm_outputs(sampler.sample(n=8, seed=0), 8)
    for cond in ({"image": images[:1]}, {"text": texts[:1]}):
        check_mm_outputs(sampler.sample(n=8, condition=cond), 8)
    for inputs in ({"image": images}, {"text": texts},
                   {"image": images, "text": texts}):
        mu, lv = sampler.embed(inputs)
        expect(mu.shape == lv.shape == (8, 64) and bool(
            torch.isfinite(mu).all() and torch.isfinite(lv).all()),
            f"multimnist embed {sorted(inputs)}")
        if len(inputs) == 1:
            check_mm_outputs(sampler.reconstruct(inputs), 8)
    print(f"[multimnist] {BEST} served every endpoint (sample, sample|image, "
          f"sample|text, embed and reconstruct)")

    model = MultiMnistMVAE(64, torch.bfloat16, device=dev,
                           generator=torch.Generator().manual_seed(40))
    multi = make_multi_train_step(
        model, MASKS, MM_LAMBDAS, lr=FAM_LR, device=dev,
        generator=torch.Generator(device=dev).manual_seed(41))
    data = to_device_data(load_multimnist(data_dir, train=True), dev)
    profiled_window(dev, card, "multimnist", multi, data, lambda k: {})
    determinism_readings(dev, card, "multimnist", multi, data)
    model, batch, eps = iwae_inputs("multimnist", dev, data_dir)
    profile_breakdown(
        f"multimnist IWAE f32 K={IWAE_K} B={BATCH} joint",
        lambda: iwae_log_marginal(model, batch, [1.0, 1.0],
                                  list(model.modalities), IWAE_K, eps=eps),
        card)
    return data_dir


def phase_celeba19(dev, card, root, data_dir):
    """Phase 6e: celeba19 end to end on the card, on the synthetic CelebA
    set of phase 6b's data directory (2000 train, 500 val, 500 test rows).
    The train CLI in bf16 at --approx-m 1 (the image BCE's bf16 math, the
    CLI's default) for CLI_EPOCHS epochs on the encoder's fused route
    (--conv-moments), --resume for one more on the default route with
    --fast-term-decode (the f32 math); the sample CLI with
    --condition-on-attrs Smiling and from the prior; the loglike CLI
    (joint, K=100); Sampler.from_checkpoint; the bf16 train step's
    profile line (profiled_window), the same under --fast-term-decode,
    and one IWAE batch's profile line."""
    out_dir = os.path.join(root, "celeba19", "models")
    argv = ["--out-dir", out_dir, "--data-dir", data_dir]
    t0 = time.perf_counter()
    # the resumed epoch runs --fast-term-decode
    tests, throughput, train_s, _ = run_train_cli(
        c19_train.main, argv, ["--conv-moments"], out_dir, "celeba19",
        resume_extra=["--fast-term-decode"])
    print(f"[celeba19] Celeba19MVAE(100) bf16 B=100 T=21, 20 steps an "
          f"epoch: {throughput} ; epoch training wall s {train_s}; test "
          f"losses {tests[:-1]}, then {tests[-1:]} after the resumed "
          f"epoch of --fast-term-decode; the CLI runs "
          f"{time.perf_counter() - t0} s | {card}")
    best = os.path.join(out_dir, BEST)
    for i, extra in enumerate(([], ["--condition-on-attrs", "Smiling"])):
        d = os.path.join(root, "celeba19", f"samples{i}")
        out, _ = run_main(c19_sample.main, [best, "--out-dir", d,
                                            "--data-dir", data_dir] + extra)
        check_images(out, 64)
        with open(os.path.join(d, "sample_attrs.txt")) as f:
            expect(len(f.read().splitlines()) == 64,
                   f"celeba19 sample {extra}: sample_attrs.txt")
    run_loglike_cli(c19_loglike.main, best, data_dir, "joint",
                    len(load_celeba(data_dir, "test")), "celeba19", card)
    sampler = Sampler.from_checkpoint(best)
    expect(type(sampler.model) is Celeba19MVAE, "celeba19: served "
           f"{type(sampler.model).__name__}")
    test = load_celeba(data_dir, "test").arrays
    images = torch.from_numpy(test["image"][:8]).to(dev)
    attrs = torch.from_numpy(test["attrs"][:8]).to(dev)
    check_images(sampler.sample(n=8, seed=0), 8)
    check_images(sampler.sample(n=8, condition={"attrs": attrs[:1]}), 8)
    for inputs in ({"image": images}, {"attrs": attrs},
                   {"image": images, "attrs": attrs}):
        mu, lv = sampler.embed(inputs)
        expect(mu.shape == lv.shape == (8, 100) and bool(
            torch.isfinite(mu).all()), f"celeba19 embed {sorted(inputs)}")
        check_images(sampler.reconstruct(inputs), 8)
    print(f"[celeba19] {BEST} served every endpoint")

    data = to_device_data(load_celeba(data_dir, "train"), dev)
    rng = np.random.default_rng(43)

    def terms(k):
        ms, ls = zip(*[c19_terms(rng) for _ in range(k)])
        return {"masks": torch.from_numpy(np.stack(ms)).to(dev),
                "lambdas": torch.from_numpy(np.stack(ls)).to(dev)}

    for fast in (False, True):
        model = Celeba19MVAE(100, torch.bfloat16, bf16_loss=not fast,
                             device=dev,
                             generator=torch.Generator().manual_seed(44))
        multi = make_multi_train_step(
            model, None, None, lr=LR, device=dev,
            generator=torch.Generator(device=dev).manual_seed(45),
            recon_support=celeba19_recon_support(1), fast_skip_decode=fast)
        profiled_window(dev, card, "celeba19" + (
            " --fast-term-decode" if fast else " T=21"), multi, data, terms)
    model, batch, eps = iwae_inputs("celeba19", dev, data_dir)
    profile_breakdown(
        f"celeba19 IWAE f32 K={IWAE_K} B={BATCH} joint",
        lambda: iwae_log_marginal(model, batch, [1.0] * 19,
                                  list(model.loglike_targets), IWAE_K,
                                  eps=eps), card, reps=2, wall_reps=3)


# --------------------------------------------------------------------------
# phase 6f: the vision family
# --------------------------------------------------------------------------

V_BATCH = 50            # experiments/vision/train.py: batch 50
V_LOG = 20              # steps a window: 2 train lines an epoch of 40
V_TEST = 500            # the synthetic set's test rows: the loglike's N
# Canny on the card against the CPU (TF32 off): a pixel whose CPU
# magnitude (or NMS interpolant, or gradient octant) lies within this
# fraction of its image's largest magnitude from the comparison that
# decides it may flip, with what hysteresis carries from it along its
# weak edge (tests/test_torch_port_vision.py holds the port to JAX so)
CANNY_TIE_RTOL = 1e-5


def check_vision_outputs(out, n, what):
    """Sampler outputs of vision: n images of each modality in [0, 1]."""
    for m in V_MODALITIES:
        expect(tuple(out[m].shape) == (n, 64, 64, V_CHANNELS[m]),
               f"{what} {m} {tuple(out[m].shape)}")
        expect(bool(torch.isfinite(out[m]).all()) and out[m].min() >= 0
               and out[m].max() <= 1, f"{what} {m} outside [0, 1]")


def phase_vision(dev, card, root, data_dir):
    """Phase 6f: vision end to end on the card, on the synthetic CelebA
    set of phase 6b's data directory (2000 train, 500 val, 500 test
    rows). derive_modalities on the card, timed, with its hysteresis
    iterations; the train CLI at its defaults (bf16, L=250, batch 50,
    T=7 terms that each reconstruct all six modalities) for CLI_EPOCHS
    epochs on the encoders' fused route (--conv-moments), --resume for one
    more on the default route streamed from the host (--no-device-data);
    a reconstruction grid each epoch; the sample CLI
    conditioned on a test image read as each of the six modalities; the
    loglike CLI (joint, K=100, the 500 test rows);
    Sampler.from_checkpoint at every endpoint; the bf16 train step's
    profile line (profiled_window), the loop's and --stack-modalities'
    (stacked_windows); one IWAE batch's profile line. Returns the train
    rows' six modalities."""
    tmp = os.path.join(root, "vision")
    out_dir = os.path.join(tmp, "models")
    rgb = load_celeba(data_dir, "train").arrays["image"]
    stats = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mods = derive_modalities(rgb, device=dev, stats=stats)
    torch.cuda.synchronize()
    print(f"[vision] derive_modalities of {len(rgb)} rows on the card: "
          f"{time.perf_counter() - t0} s wall (host copies and the host's "
          f"landmark masks included), hysteresis iterations "
          f"{stats['hysteresis_iters']} | {card}")
    argv = ["--annealing-epochs", "1", "--log-interval", str(V_LOG),
            "--out-dir", out_dir, "--data-dir", data_dir]
    t0 = time.perf_counter()
    # the resumed epoch streams from the host; its training wall (the
    # pipeline line to the epoch line) is train_s's last
    tests, throughput, train_s, resumed = run_train_cli(
        v_train.main, argv, ["--conv-moments"], out_dir, "vision",
        resume_extra=["--no-device-data"])
    expect(any(line.startswith("input pipeline: host streaming "
                               "(--no-device-data") for line in resumed),
           "vision: no host-streaming line")
    for e in range(1, CLI_EPOCHS + 2):
        with open(os.path.join(out_dir, "reconstructions",
                               f"epoch_{e}.png"), "rb") as f:
            expect(f.read(8) == b"\x89PNG\r\n\x1a\n",
                   f"vision: reconstructions/epoch_{e}.png")
    print(f"[vision] VisionMVAE(250) bf16 B=50 T=7, 40 steps an epoch: "
          f"{throughput} ; epoch training wall s {train_s[:-1]}; test "
          f"losses {tests[:-1]}, then {tests[-1:]} after the resumed epoch "
          f"streamed from the host in {train_s[-1]} s; the CLI runs "
          f"{time.perf_counter() - t0} s | {card}")

    st_dir = os.path.join(tmp, "stacked")
    t0 = time.perf_counter()
    _, lines = run_main(v_train.main, [
        "--annealing-epochs", "1", "--log-interval", str(V_LOG),
        "--out-dir", st_dir, "--data-dir", data_dir, "--epochs", "1",
        "--stack-modalities"])
    st_tests = [float(line.split()[-1]) for line in lines
                if line.startswith("====> Test Loss")]
    expect(len(st_tests) == 1 and np.isfinite(st_tests[0])
           and os.path.isfile(os.path.join(st_dir, BEST)),
           f"vision --stack-modalities: test losses {st_tests}")
    print(f"[vision] --stack-modalities, one epoch from the start: test "
          f"loss {st_tests[0]} (the loop's first epoch {tests[0]}); the "
          f"CLI runs {time.perf_counter() - t0} s | {card}")

    best = os.path.join(out_dir, BEST)
    test = load_celeb_vision(data_dir, "test", device=dev).arrays
    cond = os.path.join(tmp, "condition.png")
    write_png(cond, test["image"][0])
    t0 = time.perf_counter()
    for ctype in V_MODALITIES:
        d = os.path.join(tmp, f"samples_{ctype}")
        out, _ = run_main(v_sample.main, [
            best, "--out-dir", d, "--data-dir", data_dir, "--n-samples",
            "8", "--condition-file", cond, "--condition-type", ctype])
        check_vision_outputs(out, 8, f"vision sample | {ctype}")
        for m in V_MODALITIES:
            expect(os.path.isfile(os.path.join(d, "samples",
                                               f"sample_{m}.png")),
                   f"vision sample | {ctype}: no sample_{m}.png")
    print(f"[vision] sample CLI conditioned on each of the six modalities, "
          f"8 samples: {time.perf_counter() - t0} s | {card}")
    run_loglike_cli(v_loglike.main, best, data_dir, "joint", V_TEST,
                    "vision", card)

    sampler = Sampler.from_checkpoint(best)
    expect(type(sampler.model) is VisionMVAE, "vision: served "
           f"{type(sampler.model).__name__}")
    rows = {m: torch.from_numpy(test[m][:8]).to(dev) for m in V_MODALITIES}
    check_vision_outputs(sampler.sample(n=8, seed=0), 8, "vision prior")
    for m in V_MODALITIES:
        check_vision_outputs(sampler.sample(n=8, condition={m: rows[m][:1]}),
                             8, f"vision sample|{m}")
        mu, lv = sampler.embed({m: rows[m]})
        expect(mu.shape == lv.shape == (8, 250) and bool(
            torch.isfinite(mu).all()), f"vision embed {m}")
        check_vision_outputs(sampler.reconstruct({m: rows[m]}), 8,
                             f"vision reconstruct {m}")
    mu, _ = sampler.embed(rows)
    expect(mu.shape == (8, 250), "vision embed of all six")
    print(f"[vision] {BEST} served every endpoint (sample, sample|each "
          f"modality, embed and reconstruct of each, embed of all six)")

    model = VisionMVAE(250, torch.bfloat16, device=dev,
                       generator=torch.Generator().manual_seed(60))
    multi = make_multi_train_step(
        model, v_train.TERM_MASKS, v_train.TERM_LAMBDAS, lr=LR, device=dev,
        generator=torch.Generator(device=dev).manual_seed(61),
        recon_masks=v_train.RECON_MASKS)
    data = to_device_data(ArrayDataset(mods), dev)
    profiled_window(dev, card, "vision T=7", multi, data, lambda k: {},
                    batch=V_BATCH)
    del multi, model
    stacked_windows(dev, card, data)
    model = VisionMVAE(250, device=dev,
                       generator=torch.Generator().manual_seed(50))
    batch = {m: torch.from_numpy(test[m][:BATCH]).to(dev)
             for m in V_MODALITIES}
    eps = torch.randn((IWAE_K, BATCH, 250), device=dev,
                      generator=torch.Generator(device=dev).manual_seed(51))
    profile_breakdown(
        f"vision IWAE f32 K={IWAE_K} B={BATCH} joint (two decode chunks)",
        lambda: iwae_log_marginal(model, batch, [1.0] * 6,
                                  list(V_MODALITIES), IWAE_K, eps=eps),
        card, reps=2, wall_reps=3)
    return mods


def stacked_windows(dev, card, data):
    """vision's bf16 train step, the loop and --stack-modalities
    (VisionMVAE(stack_modalities=True)), both from one seed: a profile
    line of each (wall and device ms, launches a step, the device's idle
    share), every window's losses finite."""
    rng = np.random.default_rng(64)
    n = next(iter(data.values())).shape[0]
    idxs = torch.from_numpy(np.stack([rng.permutation(n)[:V_BATCH]
                                      for _ in range(PROFILE_K)])).to(dev)
    betas = torch.ones(PROFILE_K, device=dev)
    for flag, label in ((False, "loop"), (True, "--stack-modalities")):
        model = VisionMVAE(250, torch.bfloat16, stack_modalities=flag,
                           device=dev,
                           generator=torch.Generator().manual_seed(62))
        multi = make_multi_train_step(
            model, v_train.TERM_MASKS, v_train.TERM_LAMBDAS, lr=LR,
            device=dev, generator=torch.Generator(device=dev).manual_seed(63),
            recon_masks=v_train.RECON_MASKS)
        losses = []
        profile_breakdown(
            f"vision train bf16 B={V_BATCH} T=7 step, {label} (window of "
            f"{PROFILE_K})",
            lambda: losses.append(multi(data, idxs, betas)), card,
            reps=1, wall_reps=1, per=PROFILE_K)
        expect(all(bool(torch.isfinite(x).all()) for x in losses),
               f"vision {label}: a window's loss is not finite {losses}")


# phase 6g: the runner's row, held within SMOKE_SPREADS times the JAX
# three-seed spread s of the JAX f32 mean (a smoke bound: the row file's
# gate takes one s)
CONVERGENCE = dict(family="celeba", bf16=True, seed=0)
SMOKE_SPREADS = 2.0


def phase_convergence(dev, card, root):
    """Phase 6g: one row of the convergence runner through its entry
    point, run_row, on the card; prints the row, the JAX mean, s and the
    gap of each metric; fails on a non-finite score or a gap over
    SMOKE_SPREADS * s. Returns the row."""
    with open(parity.JAX_ROWS) as f:
        jax_rows = json.load(f)
    port = parity.run_row(device=dev, work_dir=os.path.join(
        root, "convergence"), **CONVERGENCE)
    family = CONVERGENCE["family"]
    row = parity.make_row(family, parity.PROTOCOLS[family],
                          CONVERGENCE["seed"], CONVERGENCE["bf16"], port,
                          jax_rows)
    key = parity.row_key(**CONVERGENCE)
    print(f"[convergence] {key}: {json.dumps(row)}")
    print(f"[convergence] {key}: {port['steps']} steps in "
          f"{port['train_seconds']} s ({port['steps_per_second']} steps/s, "
          f"the per-epoch eval and checkpoints included) | {card}")
    for m in parity.METRICS:
        gap, s = row["gap_to_mean"][m], row["jax_spread"][m]
        print(f"[convergence] {key} {m}: port {port[m]}, jax_mean "
              f"{row['jax_mean'][m]}, s {s}, gap {gap} (within s: "
              f"{row['within'][m]}; smoke bound {SMOKE_SPREADS} s)")
        expect(math.isfinite(port[m]), f"{key} {m} is finite")
        expect(gap <= SMOKE_SPREADS * s,
               f"{key} {m}: gap {gap} within {SMOKE_SPREADS} s = "
               f"{SMOKE_SPREADS * s}")
    return row


def canny_ties(mag, gy, gx, lo, hi):
    """Pixels where one of the Canny's decisions on (mag, gy, gx) is within
    CANNY_TIE_RTOL of its image's largest magnitude: a threshold, an NMS
    comparison (any octant case's interpolant), the octant itself."""
    r = CANNY_TIE_RTOL * mag.max(axis=(1, 2), keepdims=True)
    ai, aj = np.abs(gy), np.abs(gx)
    near = ((np.abs(mag - hi) <= r) | (np.abs(mag - lo) <= r)
            | (np.abs(ai - aj) <= r) | (ai <= r) | (aj <= r))
    with np.errstate(divide="ignore", invalid="ignore"):
        w1 = np.where(ai > 0, aj / np.where(ai > 0, ai, 1), 0)
        w2 = np.where(aj > 0, ai / np.where(aj > 0, aj, 1), 0)

    def sh(dy, dx):
        return np.roll(mag, (-dy, -dx), axis=(1, 2))

    for w, pairs in ((w1, ((sh(-1, 0), sh(-1, 1)), (sh(1, 0), sh(1, -1)),
                           (sh(1, 0), sh(1, 1)), (sh(-1, 0), sh(-1, -1)))),
                     (w2, ((sh(0, 1), sh(-1, 1)), (sh(0, -1), sh(1, -1)),
                           (sh(0, 1), sh(1, 1)), (sh(0, -1), sh(-1, -1))))):
        for c1, c2 in pairs:
            near |= np.abs(c2 * w + c1 * (1 - w) - mag) <= r
    return near


def canny_checks(dev, rgb):
    """Canny (absolute thresholds, fixpoint hysteresis) on the card against
    the CPU on the same rows: magnitudes within 1e-6 of each image's
    largest, and edges equal but in the 8-connected weak components of a
    tie pixel (canny_ties)."""
    import scipy.ndimage
    x = torch.from_numpy(rgb)
    parts = [image_ops.canny_gradients(x.to(d)) for d in ("cpu", dev)]
    mag, gy, gx = (a.numpy() for a in parts[0])
    g_mag = parts[1][0].cpu().numpy()
    scale = mag.max(axis=(1, 2), keepdims=True)
    gap = float((np.abs(g_mag - mag) / scale).max())
    expect(gap <= 1e-6, f"canny magnitude card vs CPU: {gap}")
    want = image_ops.canny_edges(x, threshold_mode="absolute").numpy()
    got, n = image_ops.canny_edges(x.to(dev), threshold_mode="absolute",
                                   return_iters=True)
    got, want = got.cpu().numpy()[..., 0], want[..., 0]
    keep = image_ops._interp_nms(*parts[0]).numpy()
    ties = canny_ties(mag, gy, gx, 0.1, 0.2)
    weak = keep & (mag >= 0.1)
    diff = got != want
    ok = ties.copy()
    for i in np.flatnonzero(diff.any(axis=(1, 2))):
        lab, _ = scipy.ndimage.label(weak[i] | (got[i] > 0),
                                     structure=np.ones((3, 3)))
        near = np.unique(lab[ties[i]])
        ok[i] |= np.isin(lab, near[near > 0])
    print(f"[check] canny card vs CPU, {len(rgb)} images: magnitude gap "
          f"{gap} of the largest (limit 1e-6), {int(diff.sum())} of "
          f"{diff.size} edge pixels differ, {int((diff & ~ok).sum())} of "
          f"them outside a tie's component; {n} hysteresis iterations")
    expect(not (diff & ~ok).any(), "canny card vs CPU: edges differ")


def phase_vision_checks(dev, mods):
    """Phase 7 for vision: one train step at T=7 with every modality
    reconstructed, kernel path against plain versions (loss above its
    floor at STEP_RTOL, every parameter gradient at GRAD_RTOL) on the
    fused route in bf16 and f32; --stack-modalities against the loop on
    one model's weights and noise (the same, and the running statistics
    after the EMA commit at EMA_TOL) in bf16 and f32; the f32 card against
    the CPU (TF32 off) on 16 rows with the same noise; Canny on the card
    against the CPU."""
    tm, tl, rm = (v_train.TERM_MASKS, v_train.TERM_LAMBDAS,
                  v_train.RECON_MASKS)
    rows = {k: v[:V_BATCH] for k, v in mods.items()}
    for dtype in (torch.bfloat16, torch.float32):
        dt = str(dtype).split(".")[-1]
        model = VisionMVAE(250, None if dtype == torch.float32 else dtype,
                           conv_moments=True, device=dev,
                           generator=torch.Generator().manual_seed(47))
        twin = copy.deepcopy(model)
        batch = decode_batch({k: torch.from_numpy(v).to(dev)
                              for k, v in rows.items()},
                             resolve_decode_dtype(model))
        noise = draw_noise(model, 7, V_BATCH, torch.Generator(
            device=dev).manual_seed(48))
        k_terms, k_grads = family_step(model, batch, tm, tl, noise,
                                       recon_masks=rm)
        with ops.plain_versions():
            p_terms, p_grads = family_step(twin, batch, tm, tl, noise,
                                           recon_masks=rm)
        held(f"vision {dt} B={V_BATCH} T=7 train step loss above floor, "
             f"kernels vs plain", k_terms, p_terms, STEP_RTOL[dtype], 0.0)
        grads_held(f"vision {dt} B={V_BATCH} T=7 train step, kernels vs "
                   f"plain",
                   k_grads, p_grads, GRAD_RTOL[dtype], GRAD_NOISE_ATOL[dtype],
                   bn_fed_biases(model))
        del model, twin, k_grads, p_grads
    for dtype in (torch.bfloat16, torch.float32):
        dt = str(dtype).split(".")[-1]
        loop = VisionMVAE(250, None if dtype == torch.float32 else dtype,
                          device=dev,
                          generator=torch.Generator().manual_seed(52))
        stacked = VisionMVAE(250, loop.compute_dtype, stack_modalities=True,
                             device=dev)
        stacked.load_state_dict(loop.state_dict())
        batch = decode_batch({k: torch.from_numpy(v).to(dev)
                              for k, v in rows.items()},
                             resolve_decode_dtype(loop))
        noise = draw_noise(loop, 7, V_BATCH, torch.Generator(
            device=dev).manual_seed(53))
        l_terms, l_grads = family_step(loop, batch, tm, tl, noise,
                                       recon_masks=rm)
        s_terms, s_grads = family_step(stacked, batch, tm, tl, noise,
                                       recon_masks=rm)
        what = f"vision {dt} B={V_BATCH} T=7 train step, stacked vs loop"
        held(f"{what}: loss above floor", s_terms, l_terms,
             STEP_RTOL[dtype], 0.0)
        grads_held(what, s_grads, l_grads, GRAD_RTOL[dtype],
                   GRAD_NOISE_ATOL[dtype], bn_fed_biases(loop))
        l_stats, s_stats = running_stats(loop), running_stats(stacked)
        held(f"{what}: running statistics after the commit",
             torch.cat([s_stats[k].flatten() for k in l_stats]),
             torch.cat([v.flatten() for v in l_stats.values()]),
             **EMA_TOL[dtype])
        del loop, stacked, l_grads, s_grads
    gpu = VisionMVAE(250, device=dev,
                     generator=torch.Generator().manual_seed(49))
    cpu = VisionMVAE(250, device="cpu",
                     generator=torch.Generator().manual_seed(49))
    small = {k: torch.from_numpy(v[:16]) for k, v in rows.items()}
    noise = draw_noise(cpu, 7, len(small["image"]),
                       torch.Generator().manual_seed(6))
    c_terms, c_grads = family_step(cpu, decode_batch(small), tm, tl, noise,
                                   recon_masks=rm)
    g_terms, g_grads = family_step(
        gpu, decode_batch({k: v.to(dev) for k, v in small.items()}), tm, tl,
        tuple(n.to(dev) for n in noise), recon_masks=rm)
    held("vision float32 B=16 T=7 train step loss above floor, card vs CPU",
         g_terms, c_terms, 1e-4, 0.0)
    grads_held("vision float32 B=16 T=7 train step, card vs CPU", g_grads,
               c_grads, GRAD_RTOL[torch.float32],
               GRAD_NOISE_ATOL[torch.float32], bn_fed_biases(cpu))
    canny_checks(dev, mods["image"][:200])


def family_floor(model):
    """Each expert's loss of all-zero logits, which random weights mostly
    pay: BCE(0, t) = ln 2 a pixel or attribute, CE(0) = ln 12 a text
    position."""
    spec = model.input_spec()
    per = {"image": np.log(2.0) * int(np.prod(spec["image"][0])),
           "text": 4 * np.log(12.0)}
    per.update({m: np.log(2.0) * int(np.prod(shape))
                for m, (shape, _) in spec.items() if len(shape) == 3})
    return torch.tensor([per.get(m, np.log(2.0)) for m in model.modalities],
                        dtype=torch.float64)


def family_step(model, batch, masks, lambdas, noise, recon_masks=None,
                **kw):
    """One train-mode ELBO and its backward, no update: (per_term less its
    floor, parameter gradients). recon_masks: vision's, which the floor
    weighs as the ELBO does."""
    model.train()
    model.zero_grad(set_to_none=True)
    dev = model.device
    m = torch.as_tensor(masks, device=dev)
    lam = torch.as_tensor(lambdas, device=dev)
    if recon_masks is not None:
        kw["recon_masks"] = torch.as_tensor(recon_masks, device=dev)
    total, aux = multi_term_elbo(model, batch, m, lam, 1.0, train=True,
                                 noise=noise, **kw)
    total.backward()
    scored = m if recon_masks is None else kw["recon_masks"]
    floor = (scored.double().cpu() * lam.double().cpu()) @ family_floor(
        model)
    return aux["per_term"].detach().double().cpu() - floor, {
        k: p.grad.detach().clone() for k, p in model.named_parameters()}


def phase_family_checks(dev, dirs):
    """Phase 7 for MultiMNIST and celeba19: one train step, kernel path
    against plain versions (loss above its floor at STEP_RTOL, every
    parameter gradient at GRAD_RTOL) in bf16 and f32, celeba19 in bf16
    with the BCE's bf16 math and with its f32 math; then in f32 the card
    against the CPU (TF32 off) on 16 rows with the same noise."""
    mm = load_multimnist(dirs["multimnist"], train=True).arrays
    cel = load_celeba(dirs["celeba"], "train").arrays
    rows = {"multimnist": {k: v[:BATCH] for k, v in mm.items()},
            "celeba19": {k: v[:BATCH] for k, v in cel.items()}}
    masks19, lambdas19 = c19_terms(np.random.default_rng(46))
    setups = (
        ("multimnist", torch.bfloat16, {}), ("multimnist", torch.float32, {}),
        ("celeba19", torch.bfloat16, {"bf16_loss": True}),
        ("celeba19", torch.bfloat16, {"bf16_loss": False}),
        ("celeba19", torch.float32, {}))
    for family, dtype, kw in setups:
        dt = str(dtype).split(".")[-1] + (
            f" bf16_loss={kw['bf16_loss']}" if kw else "")
        cls = MultiMnistMVAE if family == "multimnist" else Celeba19MVAE
        masks, lambdas = ((MASKS, MM_LAMBDAS) if family == "multimnist"
                          else (masks19, lambdas19))
        model = cls(64 if family == "multimnist" else 100,
                    None if dtype == torch.float32 else dtype, device=dev,
                    generator=torch.Generator().manual_seed(47), **kw)
        twin = copy.deepcopy(model)
        batch = decode_batch({k: torch.from_numpy(v).to(dev)
                              for k, v in rows[family].items()},
                             resolve_decode_dtype(model))
        noise = draw_noise(model, len(masks), BATCH, torch.Generator(
            device=dev).manual_seed(48))
        k_terms, k_grads = family_step(model, batch, masks, lambdas, noise)
        with ops.plain_versions():
            p_terms, p_grads = family_step(twin, batch, masks, lambdas,
                                           noise)
        held(f"{family} {dt} B=100 train step loss above floor, kernels vs "
             f"plain", k_terms, p_terms, STEP_RTOL[dtype], 0.0)
        grads_held(f"{family} {dt} B=100 train step, kernels vs plain",
                   k_grads, p_grads, GRAD_RTOL[dtype], GRAD_NOISE_ATOL[dtype],
                   bn_fed_biases(model))
    for family, cls, n_lat in (("multimnist", MultiMnistMVAE, 64),
                               ("celeba19", Celeba19MVAE, 100)):
        masks, lambdas = ((MASKS, MM_LAMBDAS) if family == "multimnist"
                          else (masks19, lambdas19))
        gpu = cls(n_lat, device=dev,
                  generator=torch.Generator().manual_seed(49))
        cpu = cls(n_lat, device="cpu",
                  generator=torch.Generator().manual_seed(49))
        small = {k: torch.from_numpy(v[:16]) for k, v in
                 rows[family].items()}
        noise = draw_noise(cpu, len(masks), len(small["image"]),
                           torch.Generator().manual_seed(6))
        c_terms, c_grads = family_step(cpu, decode_batch(small), masks,
                                       lambdas, noise)
        g_terms, g_grads = family_step(
            gpu, decode_batch({k: v.to(dev) for k, v in small.items()}),
            masks, lambdas, tuple(n.to(dev) for n in noise))
        held(f"{family} float32 B=16 train step loss above floor, card vs "
             f"CPU", g_terms, c_terms, 1e-4, 0.0)
        grads_held(f"{family} float32 B=16 train step, card vs CPU", g_grads,
                   c_grads, GRAD_RTOL[torch.float32],
                   GRAD_NOISE_ATOL[torch.float32], bn_fed_biases(cpu))


def loss_above_floor(per_term):
    """per_term less its ln 2 floor, the loss of all-zero logits
    (BCE(0, t) = ln 2 for any target), which random weights mostly pay.
    What is left, the fit and the KL, is what a wrong PoE or decode moves."""
    w = torch.tensor(MASKS, dtype=torch.float64) * torch.tensor(
        LAMBDAS, dtype=torch.float64)
    counts = torch.tensor(ELEMENTS, dtype=torch.float64)
    return per_term.double().cpu() - np.log(2.0) * (w @ counts)


def held(what, got, want, rtol, atol):
    """Print the reading, then hold got to want."""
    got, want = got.double().cpu(), want.double().cpu()
    err = (got - want).abs()
    print(f"[check] {what}: max_abs_err {err.max().item()} max_rel_err "
          f"{(err / want.abs().clamp_min(1e-30)).max().item()} "
          f"(rtol {rtol}, atol {atol})")
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol)


@torch.inference_mode()
def phase_eval_checks(dev, models, data, idx):
    """The eval step's parts against references, with BN doing real work:
    the kernel path against the plain versions on the card (posteriors of
    all terms, loss above its ln 2 floor), and in f32 the card against the
    CPU on 16 rows (posteriors, decoder logits, loss above its floor)."""
    masks = torch.tensor(MASKS, device=dev)
    for dtype, model in models.items():
        dt = str(dtype).split(".")[-1]
        step = make_eval_step(model, MASKS, LAMBDAS, device=dev,
                              device_data=True)
        _, per_term = step((data, idx))
        with ops.plain_versions():
            _, p_terms = step((data, idx))
        held(f"{dt} B=100 step loss above floor {loss_above_floor(per_term)}"
             f", kernels vs plain", loss_above_floor(per_term),
             loss_above_floor(p_terms), STEP_RTOL[dtype], 0.0)
        batch = decode_batch({k: v.index_select(0, idx)
                              for k, v in data.items()},
                             resolve_decode_dtype(model))
        mu, lv, _ = model.encode(batch)
        held(f"{dt} B=100 T=3 posteriors, poe_fwd vs plain",
             torch.cat(ops.masked_poe_all_terms(mu, lv, masks)),
             torch.cat(poe_plain(mu, lv, masks)), **POE_TOL)

    gpu = models[torch.float32]
    cpu = celeba(torch.float32, "cpu")
    rows = {k: v[idx[:16]] for k, v in data.items()}
    c_batch = decode_batch({k: v.cpu() for k, v in rows.items()})
    g_batch = decode_batch(rows)
    (c_mu, c_lv, _), (g_mu, g_lv, _) = cpu.encode(c_batch), gpu.encode(g_batch)
    held("float32 B=16 encoder mu, card vs CPU", g_mu, c_mu, **CARD_TOL)
    held("float32 B=16 encoder logvar, card vs CPU", g_lv, c_lv, **CARD_TOL)
    pd_mu, pd_lv = ops.masked_poe_all_terms(c_mu, c_lv, masks.cpu())
    z = pd_mu.reshape(-1, pd_mu.shape[-1])
    (c_rec, _), (g_rec, _) = cpu.decode(z), gpu.decode(z.to(dev))
    for k in CelebaMVAE.modalities:
        held(f"float32 T*B=48 decoder {k} logits, card vs CPU", g_rec[k],
             c_rec[k], **CARD_TOL)
    _, c_terms = make_eval_step(cpu, MASKS, LAMBDAS, device="cpu")(
        {k: v.cpu() for k, v in rows.items()})
    _, g_terms = make_eval_step(gpu, MASKS, LAMBDAS, device=dev)(rows)
    held("float32 B=16 step loss above floor, card vs CPU",
         loss_above_floor(g_terms), loss_above_floor(c_terms), 1e-4, 0.0)


def one_step(model, batch, noise):
    """One train-mode ELBO and its backward, no update: (per_term,
    parameter gradients)."""
    model.train()
    model.zero_grad(set_to_none=True)
    dev = model.device
    total, aux = multi_term_elbo(
        model, batch, torch.tensor(MASKS, device=dev),
        torch.tensor(LAMBDAS, device=dev), 1.0, train=True, noise=noise)
    total.backward()
    return aux["per_term"].detach(), {
        k: p.grad.detach().clone() for k, p in model.named_parameters()}


def bn_fed_biases(model):
    """The Linear biases that feed a BatchNorm: their exact gradient is 0."""
    out = set()
    for name, mod in model.named_modules():
        if isinstance(mod, torch.nn.Sequential):
            for i in range(len(mod) - 1):
                if (isinstance(mod[i + 1], BatchNorm)
                        and getattr(mod[i], "bias", None) is not None):
                    out.add(f"{name}.{i}.bias")
    return out


def grad_gaps(got, want, noisy):
    """(relative Frobenius gap of each gradient not in noisy, largest
    first; the largest absolute gap of those in noisy)."""
    rel, noise = [], 0.0
    for k, w in want.items():
        gap = (got[k].double().cpu() - w.double().cpu()).norm().item()
        if k in noisy:
            noise = max(noise, gap)
        else:
            rel.append((gap / max(w.double().norm().item(), 1e-30), k))
    return sorted(rel, reverse=True), noise


def grads_held(what, got, want, rtol, noise_atol, noisy):
    """Every gradient within rtol of want in relative Frobenius norm, the
    noisy ones (exactly 0 in exact arithmetic) within noise_atol of it."""
    rel, noise = grad_gaps(got, want, noisy)
    print(f"[check] {what}: {len(want)} parameter gradients, largest "
          f"relative gaps {rel[:3]} (rtol {rtol}), BN-fed biases max gap "
          f"{noise} (atol {noise_atol})")
    expect(rel[0][0] < rtol and noise < noise_atol,
           f"{what}: gradients differ")


def encoder_bn_stats(model):
    f = model.image_encoder.features
    return {f"features.{i}.{k}": getattr(f[i], k) for i in (3, 6, 9)
            for k in ("running_mean", "running_var")}


def phase_train_checks(dev, data, idx, trained):
    """One train step on the encoder's fused route, kernel path vs the
    plain versions (loss above its ln 2 floor, every parameter gradient)
    in bf16 and f32; the same step on the unfused route against the fused
    one (loss,
    gradients, the encoder BNs' committed running statistics); f32 card
    vs CPU on 16 rows with the same noise; then, from phase 5, the loss
    falling and the running statistics moved and finite."""
    route_grads = {}
    for dtype in (torch.bfloat16, torch.float32):
        dt = str(dtype).split(".")[-1]
        model = celeba(dtype, dev, seed=20)
        model.image_encoder.features.conv_moments = True
        twin = copy.deepcopy(model)
        unfused = copy.deepcopy(model)
        unfused.image_encoder.features.conv_moments = False
        batch = decode_batch({k: v.index_select(0, idx)
                              for k, v in data.items()},
                             resolve_decode_dtype(model))
        noise = draw_noise(model, 3, len(idx), torch.Generator(
            device=dev).manual_seed(5))
        k_terms, k_grads = one_step(model, batch, noise)
        with ops.plain_versions():
            p_terms, p_grads = one_step(twin, batch, noise)
        held(f"{dt} B=100 train step loss above floor, kernels vs plain",
             loss_above_floor(k_terms), loss_above_floor(p_terms),
             STEP_RTOL[dtype], 0.0)
        grads_held(f"{dt} B=100 train step, kernels vs plain", k_grads,
                   p_grads, GRAD_RTOL[dtype], GRAD_NOISE_ATOL[dtype],
                   bn_fed_biases(model))
        counts = ops.launch_counts()
        u_terms, u_grads = one_step(unfused, batch, noise)
        expect(ops.launch_counts()["conv2d_moments"]
               == counts["conv2d_moments"], "the unfused route launched "
               "conv2d_moments")
        held(f"{dt} B=100 train step loss above floor, fused vs unfused "
             f"encoder route", loss_above_floor(k_terms),
             loss_above_floor(u_terms), STEP_RTOL[dtype], 0.0)
        grads_held(f"{dt} B=100 train step, fused vs unfused encoder route",
                   k_grads, u_grads, GRAD_RTOL[dtype],
                   GRAD_NOISE_ATOL[dtype], bn_fed_biases(model))
        u_stats = encoder_bn_stats(unfused)
        for k, v in encoder_bn_stats(model).items():
            held(f"{dt} encoder BN {k} after one step, fused vs unfused",
                 v, u_stats[k], **EMA_TOL[dtype])
        route_grads[dtype] = {"fused": k_grads, "unfused": u_grads}
    # a reading, not a check: how far each bf16 route's gradients lie from
    # the f32 step's on the same weights, batch rows and noise
    want = route_grads[torch.float32]["unfused"]
    for route, grads in route_grads[torch.bfloat16].items():
        rel, _ = grad_gaps(grads, want, bn_fed_biases(model))
        print(f"[reading] bfloat16 B=100 train step, {route} encoder route "
              f"vs the float32 step: largest relative gradient gaps "
              f"{rel[:3]}")

    gpu = celeba(torch.float32, dev, seed=30)
    cpu = celeba(torch.float32, "cpu", seed=30)
    rows = {k: v[idx[:16]] for k, v in data.items()}
    eps, keep = draw_noise(cpu, 3, len(idx[:16]),
                           torch.Generator().manual_seed(6))
    c_terms, c_grads = one_step(cpu, decode_batch(
        {k: v.cpu() for k, v in rows.items()}), (eps, keep))
    g_terms, g_grads = one_step(gpu, decode_batch(rows),
                                (eps.to(dev), keep.to(dev)))
    held("float32 B=16 train step loss above floor, card vs CPU",
         loss_above_floor(g_terms), loss_above_floor(c_terms), 1e-4, 0.0)
    grads_held("float32 B=16 train step, card vs CPU", g_grads, c_grads,
               GRAD_RTOL[torch.float32], GRAD_NOISE_ATOL[torch.float32],
               bn_fed_biases(cpu))

    for dtype, run in trained.items():
        dt = str(dtype).split(".")[-1]
        first, last = run["losses"][0], run["losses"][-1]
        print(f"[check] {dt} train: mean loss of window 1 {first}, of "
              f"window {len(run['losses'])} {last}")
        expect(last < first, f"{dt} train: the loss did not fall")
        now = running_stats(run["model"])
        for k, v in now.items():
            expect(bool(torch.isfinite(v).all()), f"{dt} {k} not finite")
            expect(not torch.equal(v, run["stats0"][k]),
                   f"{dt} {k} did not move")
        print(f"[check] {dt} train: {len(now)} running statistics finite "
              f"and moved")


# phase 6h: data parallelism
DP_WORLD = 2            # ranks that share the card (gloo)
DP_WINDOWS = (1, 2)     # the two-rank replay's dispatches: one step, then 2
DP_KERNELS = ("bn_moments", "bn_bwd_partials", "poe_fwd", "bce_rowsum_fwd",
              "conv2d_moments")
DP_TIMEOUT_S = 300      # a rank's run, or a CLI process
REPO = os.path.dirname(os.path.abspath(__file__))
TP_WORLD = 8            # ranks that share the card (gloo): B=100 on 8 is
                        # the JAX package's dp4 x tp2 (gcd(8, 100) = 4)
# 6i's CelebA recipes: each dtype and each encoder route once on the grid
# (6h runs all four at dp2; the CPU tests hold every family's tp step)
TP_RECIPES = ("celeba bfloat16 unfused", "celeba float32 fused")
TP_CALLS = {"celeba": 2, "celeba19": 7}   # tp collectives a step: the head
                        # pair's all-reduce and its input's gradient's;
                        # celeba19 adds the encoder experts' gather, and
                        # on its grouped decode the gather of the terms
                        # that decode all 18 experts and the sum of the
                        # single-attribute terms' gathered experts, each
                        # call with its input's gradient's all-reduce


def dp_recipes():
    """The two-rank check's recipes (tools/dp_check.py): CelebaMVAE(100)
    from seed 20 with random BN statistics (celeba), bf16 and f32, each on
    the unfused and the fused encoder route; one window of three global
    batches of B=100 uint8 rows, the noise drawn at the global shape."""
    k = sum(DP_WINDOWS)
    rng = np.random.default_rng(61)
    data = {"image": torch.from_numpy(rng.integers(
                0, 256, (k * BATCH, 64, 64, 3), dtype=np.uint8)),
            "attrs": torch.from_numpy((rng.random((k * BATCH, 18)) < 0.3)
                                      .astype(np.float32))}
    recipes = []
    for dtype in (torch.bfloat16, torch.float32):
        model = celeba(dtype, "cpu", seed=20)
        gen = torch.Generator().manual_seed(62)
        noise = tuple(torch.stack(n) for n in zip(
            *[draw_noise(model, len(MASKS), BATCH, gen) for _ in range(k)]))
        for fused in (False, True):
            recipes.append(dp_check.recipe(
                CelebaMVAE, (100, model.compute_dtype),
                {"conv_moments": fused}, model.state_dict(), data,
                torch.tensor([0.5, 1.0, 1.0]), step_kw=dict(
                    term_masks=MASKS, term_lambdas=LAMBDAS, lr=LR),
                noise=noise, windows=DP_WINDOWS,
                name=f"celeba {str(dtype).split('.')[-1]} "
                     f"{'fused' if fused else 'unfused'}"))
    return recipes


def ranks_vs_one_process(dev, card, world, recipes, tag, more=()):
    """`world` spawned ranks share the card over gloo, on the grid of
    parallel/mesh.py over the recipes' global batches of B=100 (world 2:
    dp2; world 8: dp4 x tp2), each dp index stepping its rows of every
    batch, against this process stepping the whole batches with the same
    noise: step 1's loss, every gradient after the all-reduce (gathered
    to full shape), the running statistics and the parameters (Adam's
    first step moves an element by lr whatever its gradient: at most 2 lr
    apart; an element whose gradients on the ranks and in one process
    have opposite signs, the one process's within the gradients'
    tolerance of 0 (under rtol times the tensor's rms), took that step the
    other way, and is held by that bound alone, as the BN-fed biases are:
    the relative gap counts the other elements), then
    two more steps' losses and every rank's parameters and statistics
    equal. Prints each rank's launches and its collectives a step on each
    group. more: further (rank function, payload) jobs the same ranks run
    after the recipes (tools/dp_check.py:jobs), so that they start once.
    Returns the ranks' kernel launches, summed, and each rank's results
    of `more`."""
    n_dp, n_tp = grid(world, BATCH)
    t0 = time.perf_counter()
    refs = [dp_check.replay(rc, dev) for rc in recipes]
    t1 = time.perf_counter()
    results = dp_check.spawn_ranks(
        world, dp_check.jobs, [(dp_check.replay_all, recipes), *more],
        device=None if dev.type == "cuda" else "cpu",
        timeout_s=DP_TIMEOUT_S * (1 + len(more)))
    outs = [r[0] for r in results]
    print(f"[{tag}] one process {t1 - t0} s, {world} spawned ranks "
          f"({n_dp}-way data x {n_tp}-way tensor/expert) "
          f"{time.perf_counter() - t1} s for {len(recipes)} recipes and "
          f"{len(more)} more jobs")
    launches = {}
    steps = sum(DP_WINDOWS)
    for i, (rc, ref) in enumerate(zip(recipes, refs)):
        name = rc["name"]
        family = name.split()[0]
        noisy = bn_fed_biases(rc["model"][0](8, device="cpu"))
        dtype = rc["model"][1][1] or torch.float32
        rtol = GRAD_RTOL[dtype]
        ranks = [o[i] for o in outs]
        first = [r["windows"][0] for r in ranks]
        want = ref["windows"][0]
        loss = sum(float(w["losses"][0]) for w in first[::n_tp]) / n_dp
        held(f"{tag} {name} step 1 loss, mean of {n_dp} dp indices vs one "
             f"process", torch.tensor([loss]), want["losses"].double(),
             rtol, 0.0)
        grads_held(f"{tag} {name} step 1, rank 0 after the all-reduce vs "
                   f"one process", first[0]["grads"], want["grads"], rtol,
                   GRAD_NOISE_ATOL[dtype], noisy)
        stats = max((first[0]["running"][k].double() - v.double()).norm()
                    .item() / v.double().norm().item()
                    for k, v in want["running"].items())

        def settled(k):
            """Parameter k's elements but those whose gradient changed
            sign within rtol times its rms of 0 (a rounding's flip)."""
            g = want["grads"][k].double()
            flipped = torch.sign(first[0]["grads"][k].double()) != g.sign()
            return ~(flipped & (g.abs() <= rtol * g.square().mean().sqrt()))

        gaps, near = [], 0
        for k, v in want["params"].items():
            if k in noisy:
                continue
            keep = settled(k)
            near += int(keep.numel() - keep.sum())
            if keep.any():
                gaps.append((((first[0]["params"][k] - v)[keep].norm()
                              / v[keep].norm()).item(), k))
        gaps.sort(reverse=True)
        flips = max((first[0]["params"][k] - v).abs().max().item()
                    for k, v in want["params"].items())
        top = gaps[0][1]
        apart = ((first[0]["params"][top] - want["params"][top]).abs()
                 > LR).flatten().nonzero().flatten()
        print(f"[check] {tag} {name} step 1: running statistics largest "
              f"relative gap {stats}, parameters {gaps[:3]} (rtol "
              f"{rtol}; {near} elements whose gradient changed sign within "
              f"rtol of 0 held by the element bound alone), largest element "
              f"gap {flips} (2 lr = {2 * LR}); {top} "
              f"{tuple(want['params'][top].shape)}: {apart.numel()} "
              f"elements an Adam step apart, the first gradients "
              f"{first[0]['grads'][top].flatten()[apart][:6].tolist()} on "
              f"rank 0, {want['grads'][top].flatten()[apart][:6].tolist()} "
              f"in one process, of rms "
              f"{want['grads'][top].double().square().mean().sqrt().item()}")
        expect(stats < rtol and gaps[0][0] < rtol
               and flips <= 2 * LR * (1 + 1e-3),
               f"{tag} {name}: step 1's state differs from one process")
        rest = [r["windows"][1] for r in ranks]
        held(f"{tag} {name} steps 2-3 losses, mean of dp indices vs one "
             f"process", sum(w["losses"].double() for w in rest[::n_tp])
             / n_dp, ref["windows"][1]["losses"].double(), rtol, 0.0)
        for part in ("params", "running"):
            for k, v in rest[0][part].items():
                expect(all(torch.equal(v, w[part][k]) for w in rest[1:]),
                       f"{tag} {name}: the ranks' {k} differ")
        per = DP_WINDOWS[1]
        rank_ms = [r["windows"][1]["seconds"] * 1e3 / per for r in ranks]
        cost = {g: statistics.median(r["collective_ms"][g] for r in ranks)
                for g in ranks[0]["collective_ms"]}
        calls = {"tp": ranks[0]["tp_collectives"] / steps,
                 "dp": ranks[0]["all_reduces"] / steps}
        print(f"[{tag}] {name}: steps 2-3 on the ranks "
              f"{statistics.median(rank_ms)} ms a step (median of {world}; "
              f"{min(rank_ms)}-{max(rank_ms)}) against "
              f"{ref['windows'][1]['seconds'] * 1e3 / per} in one process "
              f"on the whole batch (host clock to a synchronize); host ms "
              f"a collective to its end {cost} (a tp all-reduce of a "
              f"(rows, 2L) posterior, a dp all-reduce of a BN's (2, 1, 64) "
              f"sums), so a step's collectives take about "
              f"{ {g: calls[g] * v for g, v in cost.items()} } ms | {card}")
        for r, o in enumerate(ranks):
            print(f"[{tag}] {name}: rank {r} launches "
                  f"{ {k: o['launches'][k] for k in DP_KERNELS} }, a step "
                  f"{o['all_reduces'] / steps} all-reduces (the BNs' on the "
                  f"dp group, the gradients' on it, or with a model axis "
                  f"on it and on the world, and then the running "
                  f"statistics' on the world) and "
                  f"{o['tp_collectives'] / steps} "
                  f"collectives on the tp group ({o['n_bn']} BN layers) | "
                  f"{card}")
            for k in DP_KERNELS:
                fused_only = k == "conv2d_moments"
                expect((o["launches"][k] > 0) == (
                    not fused_only or "unfused" not in name),
                    f"{tag} {name}: rank {r} launched {k} "
                    f"{o['launches'][k]} times")
            for k, v in o["launches"].items():
                launches[k] = launches.get(k, 0) + v
            # the gradients': with a model axis the sharded ones' on the
            # dp group and the others' on the world, then the running
            # statistics' on the world; the grouped decode's dead terms
            # run their decoders' BN layers once more, forward alone
            grads = 1 if n_tp == 1 else 3
            expect(o["all_reduces"] == (2 * o["n_bn"]
                                        + recipe_dead_bn_passes(rc)
                                        + grads) * steps,
                   f"{tag} {name}: {o['all_reduces']} all-reduces")
            expect(o["tp_collectives"] == (
                TP_CALLS[family] * steps if n_tp > 1 else 0),
                f"{tag} {name}: {o['tp_collectives']} tp collectives")
    print(f"[{tag}] {world} ranks on one card over gloo hold one process's "
          f"step: {[rc['name'] for rc in recipes]} | {card}")
    return launches, [r[1:] for r in results]


def dead_bn_passes(model, support, fast=False):
    """The BN forward passes a step of the grouped decode at recon support
    `support` runs for the terms that never train a decoder
    (core/engine.py:decode_plan)."""
    plan = decode_plan(model, support, fast_skip_decode=fast)
    return sum(isinstance(m, BatchNorm) for g in plan or ()
               for c in g.calls if not c.grad
               for m in getattr(model, f"{g.name}_decoder").modules())


def recipe_dead_bn_passes(rc):
    """dead_bn_passes of recipe rc's step (tools/dp_check.py)."""
    cls, _, kw = rc["model"]
    sk = rc["step_kw"]
    support = sk.get("recon_support")
    if support is None and sk.get("term_masks") is not None:
        support = static_support(sk["term_masks"], sk["term_lambdas"],
                                 sk.get("recon_masks"))
    return dead_bn_passes(cls(8, device="cpu", **kw), support,
                          sk.get("fast_skip_decode", False))


def dp_two_ranks(dev, card, best):
    """Phase 6h's check: two ranks, dp2, on dp_recipes; then the same
    ranks serve `best` over a group of two (serve_payload), held against
    one device (group_endpoints_held). Returns the ranks' launches."""
    inputs = serve_inputs()
    launches, more = ranks_vs_one_process(
        dev, card, DP_WORLD, dp_recipes(), "dp",
        [(dp_check.serve_endpoints, dict(
            path=best, dtype=None, inputs=inputs,
            conditions=HTTP_CONDITIONS))])
    group_endpoints_held(dev, card, best, inputs, [m[0] for m in more])
    return launches


def dp_one_rank_turns(dev, card, data, root):
    """The dp step under a process group of one NCCL rank against the step
    with no group, bf16 B=100, in windows of K=20 (ab_turns: A, B, B, A
    after a warm-up pair): ms a step, the kernel launches and the
    all-reduces a step, and a profile line of each (all-reduce device ms
    among the families)."""
    backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(
        backend, init_method=f"file://{os.path.join(root, 'dp_store')}",
        rank=0, world_size=1, timeout=datetime.timedelta(
            seconds=DP_TIMEOUT_S))
    try:
        dp = data_parallel(BATCH)
        steps = {}
        for label, group in (("no group", None), (f"1 {backend} rank", dp)):
            steps[label] = make_multi_train_step(
                celeba(torch.bfloat16, dev, seed=30), MASKS, LAMBDAS, lr=LR,
                device=dev, dp=group,
                generator=torch.Generator(device=dev).manual_seed(3))
        (a, b) = steps.items()
        times, losses = ab_turns(dev, "dp", (*a, contextlib.nullcontext),
                                 (*b, contextlib.nullcontext), data)
        print(f"[dp] bf16 B=100 K={TRAIN_K}: mean loss per window {losses}"
              f" (A, B | A, B, B, A; A {a[0]}, B {b[0]})")
        print(f"[dp] bf16 B=100 step: {b[0]} {times[b[0]]} ms, {a[0]} "
              f"{times[a[0]]} ms, host clock per window / K; "
              f"{pairs_won(times[b[0]], times[a[0]])} | {card}")
        rng = np.random.default_rng(44)
        n = next(iter(data.values())).shape[0]
        idxs = torch.from_numpy(np.stack([rng.permutation(n)[:BATCH]
                                          for _ in range(TRAIN_K)])).to(dev)
        betas = torch.ones(TRAIN_K, device=dev)
        reduces = {}
        for label, multi in steps.items():
            launches0, calls0 = ops.launch_counts(), all_reduce_sum.calls
            multi(data, idxs, betas)
            torch.cuda.synchronize()
            per = {k: (v - launches0[k]) / TRAIN_K
                   for k, v in ops.launch_counts().items()}
            reduces[label] = (all_reduce_sum.calls - calls0) / TRAIN_K
            print(f"[dp] {label}: kernel launches a step {per}, "
                  f"{reduces[label]} all-reduces a step")
            profile_breakdown(
                f"dp train bf16 B=100 step, {label} (window of {PROFILE_K})",
                lambda: multi(data, idxs[:PROFILE_K], betas[:PROFILE_K]),
                card, reps=1, wall_reps=1, per=PROFILE_K, host_top=12)
        # one all-reduce's host cost against a launch's: 200 in a row
        t = torch.zeros((2, 1, 64), device=dev)
        for what, fn in (("an all-reduce of a BN layer's (2, 1, 64) sums",
                          lambda: sum_in_place(dp.group, t)),
                         ("a launch of t.add_(0)", lambda: t.add_(0))):
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(200):
                fn()
            issued = time.perf_counter() - t0
            torch.cuda.synchronize()
            print(f"[dp] {what}: {issued * 1e3 / 200} ms of host a call "
                  f"issued, {(time.perf_counter() - t0) * 1e3 / 200} ms a "
                  f"call to the end of 200 | {card}")
        # a pass a BN layer, the grouped decode's dead terms' forward
        # passes, the gradients' all-reduce
        bn_layers = sum(layer[1] for layer in BN_LAYERS)
        dead = dead_bn_passes(CelebaMVAE(8, device="cpu"),
                              static_support(MASKS, LAMBDAS))
        expect(reduces == {a[0]: 0, b[0]: 2 * bn_layers + dead + 1},
               f"dp: all-reduces a step {reduces}")
    finally:
        dist.destroy_process_group()


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dp_cli_run(argv, out_dirs, what, world=DP_WORLD):
    """The CelebA train CLI as `world` processes started with
    --coordinator, --process-id, --n-processes; returns their stdouts
    and rank 0's lines with the host clock at which each arrived."""
    port = free_port()
    errs = [tempfile.TemporaryFile(mode="w+") for _ in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, "-u", "-m",
         "mvae_tpu_torch.experiments.celeba.train", *argv, "--out-dir",
         out_dirs[r], "--coordinator", f"127.0.0.1:{port}", "--process-id",
         str(r), "--n-processes", str(world)], cwd=REPO,
        stdout=subprocess.PIPE, stderr=errs[r], text=True)
        for r in range(world)]
    timed = []

    def read_rank_0():
        for line in procs[0].stdout:
            timed.append((time.perf_counter(), line.rstrip("\n")))

    reader = threading.Thread(target=read_rank_0, daemon=True)
    reader.start()
    outs = []
    try:
        for r, p in enumerate(procs):
            if r == 0:
                p.wait(DP_TIMEOUT_S)
                reader.join(DP_TIMEOUT_S)
                expect(not reader.is_alive(), f"{what}: rank 0's output")
                out = "\n".join(line for _, line in timed)
            else:
                out, _ = p.communicate(timeout=DP_TIMEOUT_S)
            errs[r].seek(0)
            expect(p.returncode == 0, f"{what}: rank {r} exited "
                   f"{p.returncode}:\n{errs[r].read()[-4000:]}")
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(30)
        for f in errs:
            f.close()
    return outs, timed


def epoch_wall(timed, epoch):
    """Seconds from rank 0's input-pipeline line to its epoch line."""
    start = next(t for t, line in timed
                 if line.startswith("input pipeline:"))
    end = next(t for t, line in timed
               if line.startswith(f"====> Epoch: {epoch}\t"))
    return end - start


def dp_cli(dev, card, root):
    """The CelebA train CLI on two processes that share the card (gloo),
    bf16 CelebaMVAE(100), B=100 (50 a rank), on the synthetic set (phase
    6b's settings, 20 steps an epoch): an epoch; rank 0 alone logs and
    writes; Sampler.from_checkpoint answers from its model_best.pth.tar.
    (The resume across processes is 6i's, on eight.)"""
    tmp = os.path.join(root, "dp_cli")
    dirs = [os.path.join(tmp, f"rank{r}") for r in range(DP_WORLD)]
    argv = ["--annealing-epochs", "1", "--log-interval", "10",
            "--data-dir", os.path.join(root, "celeba", "data")]
    if dev.type != "cuda":
        argv += ["--device", str(dev)]
    t0 = time.perf_counter()
    first, timed1 = dp_cli_run(argv + ["--epochs", "1"], dirs, "dp cli")
    t1 = time.perf_counter()
    lines = first[0].splitlines()
    expect(any(line.startswith("data-parallel over 2 processes "
                               "(backend gloo)") for line in lines),
           f"dp cli: no data-parallel line in {lines[:4]}")
    expect(sum(line.startswith("Train Epoch: 1 [") for line in lines) == 2,
           "dp cli: epoch 1")
    tests = [float(line.split()[-1]) for line in lines
             if line.startswith("====> Test Loss")]
    expect(len(tests) == 1 and all(np.isfinite(tests)),
           f"dp cli: test losses {tests}")
    print(f"[dp cli] rank 0, epoch 1: "
          f"{[x for x in lines if not x.startswith('Train')]}")
    expect(all(out == "" for out in first[1:]),
           f"dp cli: rank 1 printed {first[1][:200]!r}")
    expect(sorted(os.listdir(dirs[0])) == sorted([BEST, CKPT])
           and not os.path.exists(dirs[1]), "dp cli: the files")
    sampler = Sampler.from_checkpoint(os.path.join(dirs[0], BEST),
                                      compute_dtype=torch.bfloat16,
                                      device=dev)
    images = torch.rand((8, 64, 64, 3), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(9))
    check_images(sampler.reconstruct({"image": images}), 8)
    print(f"[dp cli] {DP_WORLD} processes, an epoch {t1 - t0} s (process "
          f"start, data and the build's load included); training wall from "
          f"the input-pipeline line to the epoch line "
          f"{epoch_wall(timed1, 1)} s (warm-up included); {BEST} served one "
          f"reconstruct request | {card}")


def phase_dp(dev, card, root, data, best):
    """Phase 6h: the two-rank check and Sampler(dp=2) on those ranks
    (serving `best`, 6b's model_best.pth.tar), the one-rank NCCL turns
    and the two-process CLI; returns the ranks' kernel launches."""
    launches = dp_two_ranks(dev, card, best)
    lap("dp: two ranks")
    dp_one_rank_turns(dev, card, data, root)
    lap("dp: one NCCL rank in turns")
    dp_cli(dev, card, root)
    return launches


def c19_recipe():
    """celeba19's step on the grid: Celeba19MVAE(100) in bf16 with the
    CLI's bf16 BCE math (experiments/celeba19/train.py), from seed 21,
    one window of three global batches of B=100 uint8 rows with each
    step's T=21 sampled terms (--approx-m 1), the noise drawn at the
    global shape, with the CLI's recon support (the grouped decode). At
    tp 2 a rank holds 9 of each side's 18 experts, and decodes the
    single-attribute terms' gathered experts that it holds."""
    k = sum(DP_WINDOWS)
    rng = np.random.default_rng(63)
    data = {"image": torch.from_numpy(rng.integers(
                0, 256, (k * BATCH, 64, 64, 3), dtype=np.uint8)),
            "attrs": torch.from_numpy((rng.random((k * BATCH, 18)) < 0.3)
                                      .astype(np.float32))}
    model = Celeba19MVAE(100, torch.bfloat16, bf16_loss=True, device="cpu",
                         generator=torch.Generator().manual_seed(21))
    gen = torch.Generator().manual_seed(64)
    noise = tuple(torch.stack(n) for n in zip(
        *[draw_noise(model, 21, BATCH, gen) for _ in range(k)]))
    terms_rng = np.random.default_rng(65)
    masks, lambdas = zip(*[c19_terms(terms_rng) for _ in range(k)])
    return dp_check.recipe(
        Celeba19MVAE, (100, torch.bfloat16), {"bf16_loss": True},
        model.state_dict(), data, torch.tensor([0.5, 1.0, 1.0]),
        step_kw=dict(term_masks=None, term_lambdas=None, lr=LR,
                     recon_support=celeba19_recon_support(1)),
        noise=noise, masks=torch.from_numpy(np.stack(masks)).float(),
        lambdas=torch.from_numpy(np.stack(lambdas)).float(),
        windows=DP_WINDOWS, name="celeba19 bf16 unfused")


CLI_MODULE = "mvae_tpu_torch.experiments.celeba.train"


def tp_cli_jobs(dev, root):
    """The CelebA train CLI's two runs on the TP_WORLD spawned ranks of
    the grid check (tools/dp_check.py:train_cli), bf16 CelebaMVAE(100),
    B=100: dp4 x tp2 on the synthetic set (20 steps an epoch), one epoch,
    then --resume of rank 0's checkpoint by all for a second; each rank
    its own --out-dir. Returns (the jobs, the ranks' directories)."""
    tmp = os.path.join(root, "tp_cli")
    dirs = [os.path.join(tmp, f"rank{r}") for r in range(TP_WORLD)]
    argv = ["--annealing-epochs", "1", "--log-interval", "10",
            "--batch-size", str(BATCH),
            "--data-dir", os.path.join(root, "celeba", "data"),
            "--out-dir", os.path.join(tmp, "rank{rank}")]
    if dev.type != "cuda":
        argv += ["--device", str(dev)]
    runs = (argv + ["--epochs", "1"],
            argv + ["--epochs", "2", "--resume", os.path.join(dirs[0], CKPT)])
    return [(dp_check.train_cli, (CLI_MODULE, a)) for a in runs], dirs


def tp_cli(dev, card, outs, dirs):
    """The checks of the CLI's two runs on TP_WORLD ranks (tp_cli_jobs):
    rank 0 alone logs (JAX's mesh line) and writes, each run one epoch
    with a finite test loss, the second resumed from the first;
    Sampler.from_checkpoint answers from its model_best.pth.tar on one
    device. outs: each rank's [(host time, line)] of each run. Returns
    that file."""
    n_dp, n_tp = grid(TP_WORLD, BATCH)
    mesh = (f"mesh over all {TP_WORLD} devices: {n_dp}-way data x "
            f"{n_tp}-way tensor/expert parallel (batch {BATCH} is not "
            f"divisible by {TP_WORLD}; the leftover factor shards "
            f"parameters, not nothing)")
    for run, epoch in ((0, 1), (1, 2)):
        lines = [line for _, line in outs[0][run]]
        expect(mesh in lines, f"tp cli: no mesh line in {lines[:4]}")
        expect(sum(line.startswith(f"Train Epoch: {epoch} [")
                   for line in lines) == 2, f"tp cli: epoch {epoch}")
        tests = [float(line.split()[-1]) for line in lines
                 if line.startswith("====> Test Loss")]
        expect(len(tests) == 1 and all(np.isfinite(tests)),
               f"tp cli: test losses {tests}")
        print(f"[tp cli] rank 0, epoch {epoch}: "
              f"{[x for x in lines if not x.startswith('Train')]}")
        expect(all(not o[run] for o in outs[1:]),
               f"tp cli: a rank but 0 printed {outs[1][run][:3]!r}")
    expect(any(line.startswith("resumed from ") and line.endswith(
        "at epoch 1") for _, line in outs[0][1]), "tp cli: no resume line")
    expect(sorted(os.listdir(dirs[0])) == sorted([BEST, CKPT])
           and not any(os.path.exists(d) for d in dirs[1:]),
           "tp cli: the files")
    best = os.path.join(dirs[0], BEST)
    sampler = Sampler.from_checkpoint(best, compute_dtype=torch.bfloat16,
                                      device=dev)
    images = torch.rand((8, 64, 64, 3), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(9))
    check_images(sampler.reconstruct({"image": images}), 8)
    runs = [o[-1][0] - o[0][0] for o in outs[0]]
    print(f"[tp cli] {TP_WORLD} spawned ranks, epoch 1 {runs[0]} s, the "
          f"resumed epoch 2 {runs[1]} s (rank 0's first to last line: data "
          f"and model set-up included, the ranks' start not); training wall "
          f"from the input-pipeline line to the epoch line "
          f"{epoch_wall(outs[0][0], 1)} s (warm-up included) and "
          f"{epoch_wall(outs[0][1], 2)} s; {BEST} loaded on one device and "
          f"served one reconstruct request | {card}")
    return best


SERVE_DP = 2            # ranks of the serving group (gloo on one card)
SERVE_CLIENTS, SERVE_REQUESTS = 16, 8


def launch_server(dev, best, dp):
    """serve_http's main on a process of its own, --dp dp, f32, on a free
    port; returns (the process, the port, its output's lines) at once
    (wait_serving waits for it)."""
    port = free_port()
    where = [] if dev.type == "cuda" else ["--device", str(dev)]
    proc = subprocess.Popen(
        [sys.executable, "-u", "-m", "mvae_tpu_torch.serve_http",
         "--checkpoint", best, "--family", "celeba", "--port", str(port),
         "--dp", str(dp), "--max-batch", "16", *where], cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines = []

    def read():
        for line in proc.stdout:
            lines.append(line.rstrip("\n"))

    threading.Thread(target=read, daemon=True).start()
    return proc, port, lines


def wait_serving(server, dp):
    proc, _, lines = server
    deadline = time.monotonic() + DP_TIMEOUT_S
    while not any(x.startswith("serving celeba on") for x in lines):
        expect(proc.poll() is None and time.monotonic() < deadline,
               f"serve_http --dp {dp} did not start: {lines[-20:]}")
        time.sleep(0.2)


def serve_inputs():
    """The rows every endpoint of the serving group's check takes."""
    rng = np.random.default_rng(66)
    return {"image": torch.from_numpy(rng.random((5, 64, 64, 3),
                                                 dtype=np.float32)),
            "attrs": torch.from_numpy((rng.random((5, 18)) < 0.3)
                                      .astype(np.float32))}


def group_endpoints_held(dev, card, best, inputs, outs):
    """Sampler(dp=2)'s endpoint outputs on the spawned ranks
    (tools/dp_check.py:serve_endpoints, f32 from best) against one
    device at every endpoint."""
    want = dp_check.endpoint_outputs(
        Sampler.from_checkpoint(best, device=dev),
        {k: v.to(dev) for k, v in inputs.items()}, HTTP_CONDITIONS)
    for r, o in enumerate(outs):
        expect(set(o) == set(want), f"dp serving: rank {r}'s endpoints")
        err = max((o[k] - v).abs().max().item() for k, v in want.items())
        print(f"[dp serve] Sampler(dp={SERVE_DP}) rank {r}: {len(want)} "
              f"endpoint outputs, max_abs_err {err} against one device "
              f"(CARD_TOL {CARD_TOL}) | {card}")
        for k, v in want.items():
            torch.testing.assert_close(o[k], v, **CARD_TOL)


def tp_serving(dev, card, best):
    """serve_http at --dp 2 and --dp 1 side by side (started together),
    the same /embed request to each, and serve_http_bench's burst (16
    clients x 8 one-row /embed requests, 2 ms window) in turns, dp1, dp2,
    dp2, dp1."""
    inputs = serve_inputs()
    servers = {}
    try:
        t0 = time.perf_counter()
        for dp in (1, SERVE_DP):
            servers[dp] = launch_server(dev, best, dp)
        for dp, server in servers.items():
            wait_serving(server, dp)
        print(f"[tp serve] serve_http --dp 1 and --dp {SERVE_DP} serving "
              f"{time.perf_counter() - t0} s after their start")
        expect(any(x.startswith(f"serving over a {SERVE_DP}-device data-"
                                f"parallel mesh") for x in
                   servers[SERVE_DP][2]), "tp serve: no mesh line")
        row = encode_array(inputs["image"][:1].numpy(), binary=True)
        body = json.dumps({"inputs": {"image": row}, "binary": True})
        answers = {dp: http(port, "POST", "/embed", json.loads(body))
                   for dp, (_, port, _) in servers.items()}
        for k in ("mu", "logvar"):
            a, b = (decode_array(answers[dp][1][k]) for dp in
                    (1, SERVE_DP))
            expect(answers[1][0] == answers[SERVE_DP][0] == 200
                   and np.allclose(a, b, rtol=1e-4, atol=1e-5),
                   f"tp serve: --dp {SERVE_DP}'s {k} is not --dp 1's")
        body = body.encode()
        runs = {1: [], SERVE_DP: []}
        for dp in (1, SERVE_DP, SERVE_DP, 1):
            lat, wall, error = serve_http_bench.run_clients(
                servers[dp][1], body, SERVE_CLIENTS, SERVE_REQUESTS)
            n = SERVE_CLIENTS * SERVE_REQUESTS
            expect(error is None and len(lat) == n,
                   f"tp serve: --dp {dp} burst: {error}, {len(lat)}/{n}")
            runs[dp].append((n / wall, statistics.median(lat)))
        for dp, got in runs.items():
            print(f"[tp serve] serve_http --dp {dp}, 2 ms window, "
                  f"{SERVE_CLIENTS} clients x {SERVE_REQUESTS} one-row "
                  f"/embed: requests/s {[x[0] for x in got]}, p50 ms "
                  f"{[x[1] for x in got]} (turns dp1, dp2, dp2, dp1) "
                  f"| {card}")
    finally:
        for proc, _, lines in servers.values():
            proc.send_signal(signal.SIGINT)
        for dp, (proc, _, lines) in servers.items():
            try:
                proc.wait(60)
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait(30)
            expect(proc.returncode == 0,
                   f"serve_http --dp {dp} exited {proc.returncode}: "
                   f"{lines[-20:]}")


def phase_tp(dev, card, root):
    """Phase 6i: the dp4 x tp2 steps of CelebA (bf16 on the unfused
    route, f32 on the fused one) and celeba19 on eight spawned ranks
    against one process, then on the same ranks the CelebA CLI for an
    epoch and a resume, then serve_http over a group of two beside one
    device; returns the ranks' kernel launches."""
    recipes = [rc for rc in dp_recipes() if rc["name"] in TP_RECIPES]
    cli_jobs, dirs = tp_cli_jobs(dev, root)
    launches, outs = ranks_vs_one_process(
        dev, card, TP_WORLD, recipes + [c19_recipe()], "tp", cli_jobs)
    lap("tp: eight ranks against one process, the CLI on them")
    best = tp_cli(dev, card, outs, dirs)
    tp_serving(dev, card, best)
    return launches


# phase 6j: the native host ingest (data/native.py) on the card's host
MM_FULL = (60000, 10000)        # MultiMNIST's canonical train and test rows
MM_NUMPY_ROWS = 2000            # the numpy compositor's rows, for its rate
INGEST_ROWS = (2000, 500)       # the synthetic CelebA set's train, val rows
CELEBA_WH = (178, 218)          # the aligned CelebA crop, width x height
# native against PIL, mean |gap| over a set's pixels: tests/test_native.py:78
DECODE_GAP = 4 / 255


def host_setting():
    """The host's CPU, the compiler, the image headers' versions and the
    probe of each native part; returns the CPU model."""
    with open("/proc/cpuinfo") as f:          # the first processor's
        info = dict(ln.split(":", 1) for ln in f.read().split("\n\n")[0]
                    .splitlines() if ":" in ln)
    info = {k.strip(): v.strip() for k, v in info.items()}
    # a virtual machine may name its CPU "unknown": the vendor and the
    # family, model and stepping numbers identify it all the same
    model = (f"{info.get('model name', 'an unnamed CPU')} "
             f"({info.get('vendor_id', platform.machine())} family "
             f"{info.get('cpu family', '?')} model {info.get('model', '?')} "
             f"stepping {info.get('stepping', '?')}, {platform.machine()})")
    gxx = shutil.which("g++")
    version = (subprocess.run([gxx, "--version"], capture_output=True,
                              text=True, timeout=60).stdout.splitlines()[0]
               if gxx else "no g++")
    print(f"[ingest] host: {model}, {info.get('cpu MHz', '?')} MHz, cache "
          f"{info.get('cache size', '?')}; {len(os.sched_getaffinity(0))} "
          f"cores for this process ({os.cpu_count()} online); {version}")
    for part in ("core", "decode"):
        reason = host_native.unavailable_reason(part)
        print(f"[ingest] probe {part}: "
              + ("available" if reason is None else f"unavailable: {reason}"))
    if host_native.available("decode"):
        src = ("#include <cstdio>\n#include <jpeglib.h>\n#include <png.h>\n"
               "JPEG_LIB_VERSION LIBJPEG_TURBO_VERSION PNG_LIBPNG_VER_STRING"
               "\n")
        out = subprocess.run([gxx, "-E", "-P", "-x", "c++", "-"], input=src,
                             capture_output=True, text=True, check=True,
                             timeout=60).stdout.strip().splitlines()[-1]
        print(f"[ingest] headers: JPEG_LIB_VERSION LIBJPEG_TURBO_VERSION "
              f"PNG_LIBPNG_VER_STRING = {out} (an undefined macro stays "
              f"its name)")
    return model


def read_shards(d):
    out = {}
    for split in ("training", "test"):
        with np.load(os.path.join(d, "multimnist", f"{split}.npz")) as z:
            out[split] = (z["images"], z["texts"])
    return out


def ingest_compositor(card, cpu, root):
    """make_dataset at the canonical rows with its default, the native
    compositor, twice (bit for bit alike), against the numpy path at
    MM_NUMPY_ROWS; the compositors alone on the same digits; JAX's
    validity checks (tests/test_native.py:14-42); the shards read back."""
    dirs = [os.path.join(root, "mm_full", r) for r in "ab"]
    walls = []
    for d in dirs:
        t0 = time.perf_counter()
        make_dataset(d, n_train=MM_FULL[0], n_test=MM_FULL[1])
        walls.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    make_dataset(os.path.join(root, "mm_numpy"), n_train=MM_NUMPY_ROWS,
                 n_test=0, use_native=False)
    numpy_wall = time.perf_counter() - t0
    a, b = read_shards(dirs[0]), read_shards(dirs[1])
    for split in a:
        for x, y in zip(a[split], b[split]):
            expect(np.array_equal(x, y), f"ingest: two native make_dataset "
                   f"runs differ in {split}")
    images, texts = a["training"]
    expect(images.shape == (MM_FULL[0], 50, 50) and texts.shape ==
           (MM_FULL[0], 4), f"ingest: shard shapes {images.shape}")
    counts = (texts != 11).sum(1)
    expect(set(np.unique(counts).tolist()) == {0, 1, 2, 3, 4},
           "ingest: not every digit count 0-4 occurs")
    expect(texts.min() >= 0 and texts.max() <= 11 and
           (texts[texts != 11] <= 9).all(), "ingest: labels out of range")
    expect(images[counts == 0].max() == 0, "ingest: a k = 0 canvas has ink")
    expect((images[counts > 0].reshape(-1, 2500).max(1) > 0).all(),
           "ingest: a canvas with digits is blank")
    for train, (imgs, txt) in ((True, a["training"]), (False, a["test"])):
        ds = load_multimnist(dirs[0], train=train).arrays
        expect(np.array_equal(ds["image"][..., 0],
                              imgs.astype(np.float32) / 255.0)
               and np.array_equal(ds["text"], txt),
               "ingest: load_multimnist reads other arrays")
    src = load_mnist(dirs[0], train=True, flatten=False).arrays
    digits = (src["image"].reshape(-1, 28, 28) * 255.0).astype(np.uint8)
    t0 = time.perf_counter()
    host_native.multimnist_generate(digits, src["text"], MM_FULL[0])
    gen_native = time.perf_counter() - t0
    t0 = time.perf_counter()
    mk_dataset(MM_NUMPY_ROWS, digits.astype(np.float32), src["text"],
               np.random.default_rng(MM_SEED))
    gen_numpy = time.perf_counter() - t0
    rows = sum(MM_FULL)
    print(f"[ingest] MultiMNIST make_dataset, native (default), {rows} "
          f"rows: {walls} s wall, {[rows / w for w in walls]} rows/s (the "
          f"two runs equal bit for bit; the MNIST load and the compressed "
          f"shards included); numpy (use_native=False), {MM_NUMPY_ROWS} "
          f"rows: {numpy_wall} s, {MM_NUMPY_ROWS / numpy_wall} rows/s | "
          f"{card}; {cpu}")
    print(f"[ingest] the compositors alone on the {len(digits)} synthetic "
          f"digits: native {MM_FULL[0]} rows in {gen_native} s, "
          f"{MM_FULL[0] / gen_native} rows/s; numpy {MM_NUMPY_ROWS} rows in "
          f"{gen_numpy} s, {MM_NUMPY_ROWS / gen_numpy} rows/s; ratio "
          f"{(MM_FULL[0] / gen_native) / (MM_NUMPY_ROWS / gen_numpy)} | "
          f"{card}; {cpu}")


PNG_KINDS = ("rgb", "rgba", "palette", "16bit")


def write_jpeg_tree(root):
    """The phase's copy of scripts/native_decode_impact.py:build_jpeg_tree:
    the synthetic CelebA set's INGEST_ROWS rows upsampled to the aligned
    178x218 geometry as quality-95 JPEGs with the Eval and Anno files,
    plus one PNG of each PNG_KINDS in the train partition (the 16-bit one
    a grayscale picture in the high byte, its 8-bit twin beside the
    tree). Returns the twin's path."""
    from PIL import Image
    for d in ("Eval", "Anno", "img_align_celeba"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    n_train, n_val = INGEST_ROWS
    tr, va = synthetic_celeba(n_train, seed=0), synthetic_celeba(n_val,
                                                                seed=1)
    imgs = np.concatenate([tr.arrays["image"], va.arrays["image"]])
    attrs = np.concatenate([tr.arrays["attrs"], va.arrays["attrs"]])
    names = [f"{i + 1:06d}.jpg" for i in range(len(imgs))]
    parts = [0 if i < n_train else 1 for i in range(len(imgs))]
    pics = [Image.fromarray((im * 255).astype(np.uint8)).resize(
        CELEBA_WH, Image.BILINEAR) for im in imgs]
    for name, pic in zip(names, pics):
        pic.save(os.path.join(root, "img_align_celeba", name), quality=95)
    gray = np.asarray(pics[3].convert("L"))
    pngs = {"rgb": pics[0], "rgba": pics[1].convert("RGBA"),
            "palette": pics[2].quantize(64),
            "16bit": Image.fromarray(gray.astype(np.uint16) * 257)}
    for i, kind in enumerate(PNG_KINDS):
        names.append(f"png_{kind}.png")
        parts.append(0)
        attrs = np.concatenate([attrs, attrs[i:i + 1]])
        pngs[kind].save(os.path.join(root, "img_align_celeba", names[-1]))
    twin = os.path.join(root, "..", "png_16bit_as_8bit.png")
    Image.fromarray(gray).save(twin)
    with open(os.path.join(root, "Eval", "list_eval_partition.txt"),
              "w") as f:
        f.writelines(f"{n} {p}\n" for n, p in zip(names, parts))
    with open(os.path.join(root, "Anno", "list_attr_celeba.txt"), "w") as f:
        f.write(f"{len(names)}\n" + " ".join(f"a{j}" for j in range(40))
                + "\n")
        for name, a in zip(names, attrs):
            row = -np.ones(40, np.int64)
            row[np.asarray(ATTR_IX_TO_KEEP)] = 2 * a.astype(np.int64) - 1
            f.write(name + " " + " ".join(f"{v:2d}" for v in row) + "\n")
    return twin


def ingest_decode(card, cpu, root):
    """The JPEG tree loaded through load_celeba natively and with
    exact_decode in turns (native, PIL, PIL, native): images/s each, the
    pixel gap between them (JPEG rows held under DECODE_GAP, each PNG
    apart); where the decode part is unavailable, with exact_decode
    twice. Returns the tree."""
    tree = os.path.join(root, "celeba_jpeg", "data")
    t0 = time.perf_counter()
    twin = write_jpeg_tree(tree)
    print(f"[ingest] wrote the JPEG tree ({sum(INGEST_ROWS)} JPEGs at "
          f"{CELEBA_WH[0]}x{CELEBA_WH[1]}, quality 95, and "
          f"{len(PNG_KINDS)} PNGs) in {time.perf_counter() - t0} s")
    for part in ("train", "val"):          # the attribute caches first
        load_celeba(tree, part, max_examples=1, exact_decode=True)
    decode = host_native.available("decode")
    loads, sets = {False: [], True: []}, {}
    for exact in (False, True, True, False) if decode else (True, True):
        t0 = time.perf_counter()
        sets[exact] = [load_celeba(tree, part, exact_decode=exact)
                       for part in ("train", "val")]
        loads[exact].append(time.perf_counter() - t0)
    n = sum(len(ds) for ds in sets[True])
    for exact in (False, True) if decode else (True,):
        what = "PIL (exact_decode)" if exact else "native"
        print(f"[ingest] load_celeba {what}: {n} images in {loads[exact]} s, "
              f"{[n / t for t in loads[exact]]} images/s | {card}; {cpu}")
    if not decode:
        print("[ingest] the native decode not measured: "
              + host_native.unavailable_reason("decode"))
        return tree
    nat = np.concatenate([ds.arrays["image"] for ds in sets[False]])
    pil = np.concatenate([ds.arrays["image"] for ds in sets[True]])
    expect(nat.shape == pil.shape == (n, 64, 64, 3)
           and np.isfinite(nat).all(), f"ingest: decoded {nat.shape}")
    gap = np.abs(nat - pil) * 255.0
    n_train = INGEST_ROWS[0]
    jpeg = np.concatenate([gap[:n_train], gap[n_train + len(PNG_KINDS):]])
    mean, p99 = float(jpeg.mean()), float(np.percentile(jpeg, 99))
    png_gaps = {k: float(gap[n_train + i].mean())
                for i, k in enumerate(PNG_KINDS)}
    print(f"[ingest] native against PIL over the {len(jpeg)} JPEGs: mean "
          f"|gap| {mean} / 255, p99 {p99} / 255, max {float(jpeg.max())} / "
          f"255; each PNG's mean |gap| / 255: {png_gaps} (PIL clips a "
          f"16-bit PNG at 255 where libpng keeps the high byte)")
    expect(mean < DECODE_GAP * 255, f"ingest: mean JPEG gap {mean} / 255")
    for k in ("rgb", "rgba", "palette"):
        expect(png_gaps[k] < DECODE_GAP * 255, f"ingest: {k} PNG gap")
    expect(np.array_equal(nat[n_train + PNG_KINDS.index("16bit")],
                          host_native.decode_image_64(twin).astype(
                              np.float32) / 255.0),
           "ingest: the 16-bit PNG is not its 8-bit twin")
    return tree


def ingest_cli(card, cpu, tree, root):
    """The CelebA train CLI on the JPEG tree in bf16 (the defaults), two
    epochs (the driver prints its Throughput line from the second) by
    default and with --exact-decode, each into a new directory: the
    loaders' wall time, the Throughput line, finite losses."""
    real, loads = celeba_cli.load_celeba, []

    def timed(*args, **kw):
        t0 = time.perf_counter()
        ds = real(*args, **kw)
        loads.append((time.perf_counter() - t0, kw.get("exact_decode")))
        return ds
    celeba_cli.load_celeba = timed
    try:
        for flags in ([], ["--exact-decode"]):
            out_dir = tempfile.mkdtemp(dir=root, prefix="ingest_cli_")
            rec = TimedLines(sys.stdout)
            with contextlib.redirect_stdout(rec):
                celeba_cli.main(["--epochs", "2", "--annealing-epochs", "1",
                                 "--log-interval", "10", "--data-dir", tree,
                                 "--out-dir", out_dir] + flags)
            lines = [line for _, line in rec.lines]
            losses = [float(line.split()[-1]) for line in lines
                      if line.startswith(("====> Epoch", "====> Test Loss"))]
            throughput = [line for line in lines if "Throughput" in line]
            expect(len(losses) == 4 and all(np.isfinite(losses)),
                   f"ingest CLI {flags}: losses {losses}")
            # the default run says so where the native decode is
            # unavailable, once for each of its two loaders
            said = sum("native decode unavailable" in line for line in lines)
            expect(said == (0 if flags or host_native.available("decode")
                            else 2), f"ingest CLI {flags}: {said} lines "
                   "on the decode")
            expect(len(throughput) == 1 and not any(
                "synthetic" in line for line in lines),
                f"ingest CLI {flags}: {lines[:3]}")
            expect([e for _, e in loads[-2:]] == [bool(flags)] * 2,
                   f"ingest CLI {flags}: the loaders got {loads[-2:]}")
            what = ("--exact-decode" if flags else "the default, native "
                    "decode" if host_native.available("decode") else
                    "the default, PIL (no native decode here)")
            print(f"[ingest] CelebA CLI on the JPEG tree, {what}: "
                  f"train and val load {[t for t, _ in loads[-2:]]} s; "
                  f"{throughput[0]}; epoch and test losses {losses} | "
                  f"{card}; {cpu}")
    finally:
        celeba_cli.load_celeba = real


def phase_ingest(dev, card, root):
    """Phase 6j: the native host ingest on the card's host. Where the probe
    finds no image headers, the native decode's part is skipped (said so)
    and the JPEG tree's loads and CLI runs go through PIL."""
    cpu = host_setting()
    for part in ("core", "decode"):
        if host_native.available(part):
            lib = host_native.library(part)
            print(f"[ingest] {part} library built and loaded in "
                  f"{lib.build_seconds} s (phase 1)")
    expect(host_native.available("core"), "ingest: the core library "
           "cannot build: " + str(host_native.unavailable_reason("core")))
    ingest_compositor(card, cpu, root)
    lap("ingest: the compositor")
    tree = ingest_decode(card, cpu, root)
    lap("ingest: the decode")
    ingest_cli(card, cpu, tree, root)


# phase 6k: the port's measuring tools (mvae_tpu_torch/tools/), each at full
# width through its main(), as `python -m mvae_tpu_torch.tools.<tool>` runs
BENCH_RUNS = (
    (bench_tool, ["--k", "20", "--windows", "5"]),
    (bench_families, ["--bf16", "--flops", "--k", "20"]),
    (roofline_family, ["--family", "celeba", "--bf16", "--top", "10",
                       "--k", "20"]),
    (serve_latency, ["--model", "celeba"]),    # + 6b's checkpoint
    (serve_latency, ["--model", "mnist"]))
MFU_MAX = 1.05          # above the peak only by the peak's rounding


def flops_against_the_counter(dev, card):
    """FlopCounterMode's count of one shipped CelebA train step on the card
    (CelebaMVAE(100) bf16, B=100, T=3, the default route: no kernel of the
    port does a product it would count) against measure.count_step from
    shapes: the step's FLOPs plus the dead work the grouped decode runs
    (the forward alone of the image decoder for the attrs-only term and
    of the attribute decoder for the image-only term), exactly."""
    model = celeba(torch.bfloat16, dev, seed=11)
    step = make_train_step(model, MASKS, LAMBDAS, lr=LR, device=dev,
                           generator=torch.Generator(device=dev).manual_seed(2),
                           device_data=True)
    data, idx = eval_data(dev)
    step((data, idx), 0.5)
    with FlopCounterMode(display=False) as counter:
        step((data, idx), 0.5)
        torch.cuda.synchronize()
    got = counter.get_total_flops()
    want = measure.count_step(model, MASKS, LAMBDAS, BATCH)
    print(f"[bench] one CelebA bf16 train step: FlopCounterMode "
          f"{got} FLOPs; from shapes flops_per_step {want.needed} + dead "
          f"forwards {want.dead} = {want.needed + want.dead} | {card}")
    expect(got == want.needed + want.dead,
           f"FlopCounterMode counts {got}, the shapes "
           f"{want.needed} + {want.dead}")


def phase_bench(dev, card, celeba_dir):
    """Phase 6k: tools/bench.py (the reference flow in turns), tools/
    bench_families.py (all six families, bf16, FLOPs), tools/
    roofline_family.py (celeba, the top 10 kernels) and tools/
    serve_latency.py (celeba from 6b's checkpoint, mnist's quick sampler)
    at full width on the card. Every JSON line a tool prints parses and
    is what it returned; every mfu lies in (0, MFU_MAX], every idle share
    in [0, 1]; each line names this card; then the FLOP count from shapes
    against FlopCounterMode's."""
    name = torch.cuda.get_device_name(0)
    printed = TimedLines(sys.stdout)
    records = []
    with contextlib.redirect_stdout(printed):
        for tool, argv in BENCH_RUNS:
            if tool is serve_latency and "celeba" in argv:
                argv = [os.path.join(celeba_dir, BEST)] + argv
            out = tool.main(argv)
            records += out if isinstance(out, list) else [out]
            lap(f"bench: {tool.__name__.split('.')[-1]} {' '.join(argv)}")
    parsed = [json.loads(line) for _, line in printed.lines
              if line.startswith("{")]
    expect(parsed == records, "bench: the printed lines are not the "
           "tools' records")
    for rec in records:
        what = rec.get("metric") or rec.get("family") or rec.get("endpoint")
        expect(isinstance(rec["device"], dict)
               and rec["device"]["name"] == name
               and rec["device"]["power_limit"],
               f"bench {what}: device {rec['device']}")
        if rec.get("mfu") is not None or "flops_per_step" in rec:
            expect(rec.get("mfu") is not None
                   and 0 < rec["mfu"] <= MFU_MAX,
                   f"bench {what}: mfu {rec.get('mfu')}")
        if "idle_share" in rec:
            expect(0 <= rec["idle_share"] <= 1,
                   f"bench {what}: idle share {rec['idle_share']}")
        if "p50_ms" in rec:
            expect(0 < rec["p50_ms"] <= rec["p95_ms"],
                   f"bench {what}: p50 {rec['p50_ms']}")
    head = records[0]
    expect(head["vs_baseline"] > 0 and head["windows"]["count"] == 10
           and head["baseline_windows"]["count"] == 10,
           f"bench: {head['windows']}, {head['baseline_windows']}")
    roof = next(r for r in records if "port_kernels" in r)
    expect(set(roof["port_kernels"]) == set(KERNELS)
           and len(roof["top_kernels"]) == 10,
           f"roofline: {roof['port_kernels']}")
    print(f"[bench] {len(records)} JSON lines; CelebA {head['value']} "
          f"steps/s, {head['vs_baseline']} times the reference flow's "
          f"{head['baseline_steps_per_sec']}, mfu {head['mfu']} | {card}")
    flops_against_the_counter(dev, card)


# phase 6l: the CelebA window by kernel category with the step's FLOP and
# byte bound (tools/roofline_celeba.py, on phase 6b's traced resumed
# window), and celeba19's step by stage (tools/profile_celeba19.py)
STAGE_RUNS = ["--k", "20"]
BOUND_SHARE_MAX = 1.05      # the bound's share of the device ms a step


def phase_tools(dev, card, celeba_dir):
    """Phase 6l: tools/roofline_celeba.py on the trace of 6b's resumed
    epoch (its second window of 10 steps, the default route: CelebaMVAE(100)
    bf16, B=100, T=3; where that trace lost more than measure.LOST_MAX
    kernel records, on a window of 20 that the tool's --capture traces)
    and tools/profile_celeba19.py at K=20 in f32 and bf16. Every JSON line
    parses, is what the tool returned and names this card; the bound's share of the device ms a step lies in (0,
    BOUND_SHARE_MAX]; every stage's wall ms, device ms and launches are
    positive. Prints each distinct kernel of the window once with the op
    that launched it and its family, and fails unless the profiler linked
    kernels to convolution ops and every one of them is in the conv family,
    by its op and (memsets aside) by its name alone."""
    trace_dir = os.path.join(os.path.dirname(celeba_dir), "trace")
    roof_argv, steps = ["--trace-dir", trace_dir, "--k", "10"], 10
    lost = roofline_celeba.analyze(os.path.join(trace_dir, "trace.json"),
                                   10)["records_lost"]
    if lost > measure.LOST_MAX:
        print(f"[tools] the trace of 6b's resumed run lost {lost} kernel "
              f"records: roofline_celeba --capture traces its own window of "
              f"20")
        roof_argv = ["--capture", "--trace-dir", os.path.join(
            os.path.dirname(celeba_dir), "roofline_trace")]
        steps = 20
    name = torch.cuda.get_device_name(0)
    printed = TimedLines(sys.stdout)
    with contextlib.redirect_stdout(printed):
        roof = roofline_celeba.main(roof_argv)
        lap("tools: roofline_celeba")
        stages = profile_celeba19.main(STAGE_RUNS)
        lap("tools: profile_celeba19 " + " ".join(STAGE_RUNS))
    parsed = [json.loads(line) for _, line in printed.lines
              if line.startswith("{")]
    expect(parsed == [roof] + stages, "tools: the printed lines are not the "
           "tools' records")
    for rec in parsed:
        expect(isinstance(rec["device"], dict)
               and rec["device"]["name"] == name
               and rec["device"]["power_limit"],
               f"tools: device {rec['device']}")
    share = roof["bound_share_of_device"]
    expect(share is not None and 0 < share <= BOUND_SHARE_MAX,
           f"roofline_celeba: the bound's share of the device ms {share}")
    expect(roof["steps"] == steps, f"roofline_celeba: {roof['steps']} "
           f"steps")
    print(f"[tools] CelebA bf16 B=100 window of {roof['steps']}: device "
          f"{roof['device_ms_per_step']} ms, wall {roof['wall_ms_per_step']} "
          f"ms ({roof['traced_wall_ms_per_step']} traced), idle share "
          f"{roof['idle_share']}, {roof['launches_per_step']} launches a "
          f"step; "
          f"{roof['flops_per_step']} FLOPs, bytes_ops {roof['bytes_ops']}, "
          f"bytes_floor {roof['bytes_floor']}; bound {roof['bound_ms']} ms "
          f"by {roof['bound_by']}, {share} of the device ms, "
          f"{roof['bound_share_of_wall']} of the wall | {card}")
    for rec in stages:
        for row in rec["stages"]:
            expect(all(row[k] is not None and row[k] > 0 for k in
                       ("wall_ms", "device_ms", "launches")),
                   f"profile_celeba19 {rec['precision']}: {row}")
    window = roofline_celeba.analyze(roof["trace"], steps)
    seen = {}
    for r in window["launchers"]:
        seen.setdefault(r["kernel"], []).append(r)
    for kernel, rows in seen.items():
        print(f"[families] {' / '.join(sorted({r['family'] for r in rows}))}"
              f" | by name {rows[0]['by_name']} | launched by "
              f"{sorted({str(r['op']) for r in rows})} | {kernel[:160]}")
    # a convolution op's kernels; its memsets are no kernels and have no
    # family by their name
    conv = [r for r in window["launchers"] if r["op"] is not None
            and measure.family_of("", r["op"]) == measure.CONV]
    wrong = [r for r in conv if r["family"] != measure.CONV
             or (r["by_name"] != measure.CONV
                 and not r["kernel"].startswith(("Memset", "Memcpy")))]
    expect(conv and not wrong, f"tools: kernels launched by convolution "
           f"ops outside the conv family: {wrong}")
    print(f"[tools] {len(conv)} (kernel, convolution op) pairs, all conv by "
          f"op and by name; kernels linked to an op "
          f"{window['kernels_linked_to_an_op']} | {card}")
    # the live profiler's links (measure.profile_records): a float32
    # convolution's forward and backward (TF32 off: cuDNN may take its
    # GEMM-based algorithms) and a product, each kernel by its op; 20
    # calls, since a profile of a millisecond or two came back without
    # its device events in two of three runs on the card
    x = torch.randn((100, 64, 32, 32), device=dev, requires_grad=True)
    w = torch.randn((128, 64, 4, 4), device=dev, requires_grad=True)
    a = torch.randn((1024, 1024), device=dev)
    prof = profile_breakdown(
        "a float32 conv forward and backward and a product",
        lambda: (F.conv2d(x, w, stride=2, padding=1).sum().backward(),
                 a @ a), card, reps=20, wall_reps=5)
    linked = [r for r in prof["launchers"] if r["op"] is not None]
    expect(any(r["family"] == measure.CONV for r in linked)
           and any(r["family"] == measure.GEMM for r in linked)
           and all(r["family"] == measure.CONV for r in linked
                   if measure.family_of("", r["op"]) == measure.CONV),
           f"tools: the profiler's links {prof['launchers']}")
    for r in prof["launchers"]:
        print(f"[families] profiler: {r['family']} | by name "
              f"{r['by_name']} | launched by {r['op']} | {r['kernel'][:120]}")


_START = time.perf_counter()
_LAPS = [_START]


def lap(what):
    """Where the run's time goes: seconds since the script started, and
    since the last lap."""
    now = time.perf_counter()
    print(f"[time] {what}: {now - _START} s since the start, "
          f"{now - _LAPS[-1]} s since the last lap")
    _LAPS.append(now)


def run(dev, card, peaks, root):
    """Phases 2-7 with their files under root; returns the kernel rows of
    phase 2 and the launches of phases 3-5 and 6b-6l."""
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    # what device_ms reads for a launch with next to no work: every kernel
    # time below carries about this much; back_to_back_ms takes most of it
    # out. bn_bwd_partials' kernel on 2 rows of 8 channels, the rows in
    # one block (a plain launch) or one each in a cluster of 2
    tiny = (torch.zeros((1, 2, 8, 1), device=dev),) * 2 + (
        torch.ones((1, 8), device=dev),) * 2
    for splits, kind in ((1, "a plain launch"), (2, "a cluster of 2")):
        fn = reduction_at("partials", (1, 1, splits, 2 // splits, 256, 8))
        t_one = device_ms(lambda: fn(*tiny), flush)
        t_b2b = back_to_back_ms(fn, tiny, flush)
        print(f"[kernel] floor: bn_bwd_partials on a (1, 2, 8, 1) view "
              f"({kind}) reads {t_one} ms, back_to_back_ms {t_b2b} | {card}")
    rows = phase_kernels(dev, card, peaks, flush)
    rows.update(phase_bn_kernels(dev, card, peaks, flush))
    rows.update(phase_conv_kernels(dev, card, peaks, flush))
    del flush
    lap("kernels against their plain versions")

    models = {dt: celeba(dt, dev) for dt in (torch.bfloat16, torch.float32)}
    data, idx = eval_data(dev)
    trained = {}
    # each path with the counts set to 0 just before it, read just after;
    # the kernels each path must have launched
    must = {"serve": ("poe_fwd",), "serve_http": ("poe_fwd",),
            "eval": ("poe_fwd", "bce_rowsum_fwd"),
            "train": tuple(KERNELS), "cli": tuple(KERNELS),
            "grouped": ("poe_fwd", "poe_bwd", "bce_rowsum_fwd") + BN_KERNELS,
            "families": ("poe_fwd", "poe_bwd", "bce_rowsum_fwd"),
            "multimnist": ("poe_fwd", "poe_bwd", "bce_rowsum_fwd")
            + BN_KERNELS, "celeba19": tuple(KERNELS),
            "vision": tuple(KERNELS),
            "convergence": ("poe_fwd", "poe_bwd", "bce_rowsum_fwd")
            + BN_KERNELS, "dp": tuple(KERNELS), "tp": tuple(KERNELS),
            "ingest": ("poe_fwd", "poe_bwd", "bce_rowsum_fwd")
            + BN_KERNELS, "bench": ("poe_fwd", "poe_bwd", "bce_rowsum_fwd")
            + BN_KERNELS, "tools": ("poe_fwd", "poe_bwd", "bce_rowsum_fwd")
            + BN_KERNELS}
    launches, out = {}, {}
    for phase, fn in (
            ("serve", lambda: phase_serving(dev, card)),
            ("serve_http", lambda: phase_serving_http(dev, card)),
            ("eval", lambda: phase_eval(dev, card, models, data, idx)),
            ("train", lambda: phase_train(dev, card, data, trained)),
            ("grouped", lambda: phase_grouped(dev, card, data)),
            ("cli", lambda: phase_cli(dev, card, root)),
            ("families", lambda: phase_families(dev, card, root,
                                                out["cli"])),
            ("multimnist", lambda: phase_multimnist(dev, card, root)),
            ("celeba19", lambda: phase_celeba19(
                dev, card, root, out["families"]["celeba"])),
            ("vision", lambda: phase_vision(
                dev, card, root, out["families"]["celeba"])),
            ("convergence", lambda: phase_convergence(dev, card, root)),
            ("dp", lambda: phase_dp(dev, card, root, data,
                                    os.path.join(out["cli"], BEST))),
            ("tp", lambda: phase_tp(dev, card, root)),
            ("ingest", lambda: phase_ingest(dev, card, root)),
            ("bench", lambda: phase_bench(dev, card, out["cli"])),
            ("tools", lambda: phase_tools(dev, card, out["cli"]))):
        ops.reset_launch_counts()
        out[phase] = fn()
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        print(f"[launches] {phase}: {counts}")
        lap(phase)
        for k in must[phase]:
            expect(counts[k] > 0, f"{phase} ran no {k}")
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
    for phase in ("dp", "tp"):              # the spawned ranks' own
        for k, v in out[phase].items():
            launches[k] += v
    phase_eval_checks(dev, models, data, idx)
    phase_train_checks(dev, data, idx, trained)
    phase_iwae_checks(dev, out["families"])
    phase_family_checks(dev, {"multimnist": out["multimnist"],
                              "celeba": out["families"]["celeba"]})
    lap("checks before vision's")
    phase_vision_checks(dev, out["vision"])
    lap("checks, the whole run")
    return rows, launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    name = torch.cuda.get_device_name(0)
    card = f"{name}, {smi.split(',')[-1].strip()}"
    peaks = card_peaks(name)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}; peaks {peaks[0] / 1e12} TB/s, "
          f"{peaks[1] / 1e12} f32 TFLOP/s, {peaks[2] / 1e12} bf16 "
          f"tensor-core TFLOP/s")
    lib = ops.library()
    print(f"[build] kernels built and loaded in {lib.build_seconds} s")
    # the host library's parts (data/native.py): core must build; decode
    # where the probe finds the image headers (phase 6j says which)
    for part in ("core", "decode"):
        if part == "core" or host_native.available(part):
            print(f"[build] host library {part} built and loaded in "
                  f"{host_native.library(part).build_seconds} s")
    lap("start and build")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
        rows, launches = run(dev, card, peaks, root)

    line = [{"name": k, **KERNELS[k], "launches": launches[k],
             "max_abs_err": rows[k]["max_abs_err"], "ms": rows[k]["ms"],
             "back_to_back_ms": rows[k]["back_to_back_ms"],
             "plain_ms": rows[k]["plain_ms"], "bound_ms": rows[k]["bound_ms"],
             "bound_by": rows[k]["bound_by"],
             "library_ms": rows[k]["library_ms"],
             "cases": rows[k].get("cases", [])} for k in KERNELS]
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
