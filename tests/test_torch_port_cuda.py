"""The port's CUDA kernels and paths on the card. Every test here needs an
NVIDIA GPU (marker `cuda`) and skips without one. The file imports nothing
of JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py -q
"""

import contextlib
import copy

import numpy as np
import pytest
import torch

from mvae_tpu_torch import ops
from mvae_tpu_torch.core.engine import multi_term_elbo
from mvae_tpu_torch.core.engine import decode_plan
from mvae_tpu_torch.core.subsets import (
    celeba19_recon_support, celeba19_step_terms)
from mvae_tpu_torch.models.celeba import CelebaMVAE
from mvae_tpu_torch.models.celeba19 import Celeba19MVAE
from mvae_tpu_torch.models.multimnist import MultiMnistMVAE
from mvae_tpu_torch.models.vision import CHANNELS, MODALITIES, VisionMVAE
from mvae_tpu_torch.nn.norm import BatchNorm
from mvae_tpu_torch.ops import bn as bn_ops
from mvae_tpu_torch.ops import convbn
from mvae_tpu_torch.ops.elbo import bce_rowsum_plain
from mvae_tpu_torch.ops.poe import poe_bwd_plain, poe_plain
from mvae_tpu_torch.serve import Sampler
from mvae_tpu_torch.train.loop import (
    decode_batch, draw_noise, make_eval_step, make_multi_train_step)

pytestmark = pytest.mark.cuda

MASKS = [[1.0, 1.0], [1.0, 0.0], [0.0, 1.0]]
LAMBDAS = [[1.0, 10.0]] * 3
# kernel vs plain version, both f32: sums taken in another order
POE_TOL = dict(rtol=1e-5, atol=1e-6)
BCE_TOL = dict(rtol=1e-5, atol=1e-4)
# BN passes: the per-(g, c) sums over up to 102400 elements in another
# order, compared as means; y and dx from the same f32 formula (a last-bit
# difference in exp); in bf16 both round one f32 value, so a rare
# rounding moves by one bf16 step (2^-8 relative)
BN_SUM_TOL = dict(rtol=1e-5, atol=1e-6)
BN_OUT_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
              torch.bfloat16: dict(rtol=2 ** -7, atol=1e-5)}
# bn_dx's dscale and dbias add the G groups' (C,) terms in another order
# than torch.sum does; at celeba19's G = 21 the terms cancel (a sum of 0.87
# from terms of several units read 9.8e-6 apart), so with more than 3
# groups they are held to the bound of a reordered f32 sum: this rtol times
# the sum of the terms' magnitudes, plus BN_SUM_TOL's atol
GROUP_SUM_RTOL = 1e-5
# conv2d_moments against its plain version (cuDNN, TF32 off): f32 y sums
# up to 2048 products in another order; bf16 y rounds an f32 accumulator
# once on both sides, so a rare y sits one bf16 step apart (2^-7
# relative); the sums compared as means over the B*OH*OW pixels
CONV_Y_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-4),
              torch.bfloat16: dict(rtol=2 ** -7, atol=1e-5)}
CONV_SUM_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
                torch.bfloat16: dict(rtol=1e-4, atol=1e-4)}
# the encoder's BN'd convs at B=100: (B, C_in, H, C_out, stride, padding),
# then ragged and small ones: pixels, channels and K off the kernel's
# tiles, M below one tile, B = 1, rows of x that are not whole 16-byte
# chunks (H = W = 6, 10 at stride 2; 4, 7, 12 at stride 1), C_in = 3, 16
CONV_SHAPES = [(100, 32, 32, 64, 2, 1), (100, 64, 16, 128, 2, 1),
               (100, 128, 8, 256, 1, 0), (3, 3, 6, 8, 2, 1),
               (1, 32, 32, 64, 2, 1), (2, 16, 10, 40, 2, 1),
               (5, 3, 4, 96, 1, 0), (7, 16, 7, 40, 1, 0),
               (1, 5, 12, 8, 1, 0), (9, 6, 24, 33, 2, 1),
               (4, 5, 64, 70, 2, 1), (33, 24, 9, 20, 1, 0)]
# vision's three BN'd encoder convs at its batch of 50
CONV_VISION = [(50, 32, 32, 64, 2, 1), (50, 64, 16, 128, 2, 1),
               (50, 128, 8, 256, 1, 0)]
CONV_SHAPES += CONV_VISION
# the first four are held to the plain sums at CONV_SUM_TOL as they stand
CONV_SHAPES_STRICT = CONV_SHAPES[:4]
# the BN layers of the CelebA train step at B=100: (G, N, C, S), then
# S = 1 with C off the 32 channels of a block and N = 1, S = 25 and 3 on
# few rows, many rows, rows longer than a block
BN_SHAPES = [(1, 100, 64, 256), (1, 100, 128, 64), (1, 100, 256, 25),
             (1, 100, 512, 1), (3, 100, 128, 64), (3, 100, 64, 256),
             (3, 100, 32, 1024), (3, 100, 512, 1), (1, 1, 7, 1),
             (1, 33, 50, 1), (2, 3, 4, 25), (2, 5, 40, 3), (1, 1000, 8, 16),
             (1, 2, 3, 4096), (1, 1000, 20, 1), (3, 300, 9, 2),
             # MultiMNIST's encoder and decoder (S = 144, 36, 4; 36, 144,
             # 625: bf16 planes of no whole 16-byte chunk but at 144),
             # then celeba19's decoder at G = 21 terms
             (1, 100, 64, 144), (1, 100, 128, 36), (1, 100, 256, 4),
             (3, 100, 128, 36), (3, 100, 64, 144), (3, 100, 32, 625),
             (21, 100, 128, 64), (21, 100, 64, 256), (21, 100, 32, 1024),
             # vision's encoders (B = 50) and decoders (G = 7 terms)
             (1, 50, 64, 256), (1, 50, 128, 64), (1, 50, 256, 25),
             (7, 50, 128, 64), (7, 50, 64, 256), (7, 50, 32, 1024)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# (T, M, B): serving's one mask row, the steps' three terms, celeba19's
# expert count over more terms than poe_bwd has in flight, and celeba19's
# step (T = 21) and infer / IWAE proposal (T = 1) at the expert cap 32
POE_CASES = [(1, 2, 1), (1, 2, 64), (3, 2, 100), (5, 19, 7), (21, 19, 100),
             (1, 19, 100), (7, 6, 50), (1, 6, 50)]
# (T, M, B, D) with B*D off the 128 columns of a block (1, 7, 10003) or not
# (6400), at each expert cap
POE_RAGGED = [(3, 2, 1, 1), (3, 2, 1, 7), (3, 2, 64, 100), (3, 2, 7, 1429),
              (2, 8, 3, 7), (2, 8, 64, 100), (9, 32, 5, 3), (1, 1, 7, 1),
              # vision's step (T = 7) and infer / IWAE proposal (T = 1):
              # M = 6 at the expert cap 8, D = 250
              (7, 6, 50, 250), (1, 6, 50, 250)]


def _poe_inputs(cuda, t, m, b, d=100):
    """mu, logvar, 0/1 masks with the full subset first, upstream
    gradients (T, B, D) of both outputs."""
    g = torch.Generator(device=cuda).manual_seed(t * 10 + m)
    mu = torch.randn((m, b, d), generator=g, device=cuda)
    lv = torch.randn((m, b, d), generator=g, device=cuda)
    masks = (torch.rand((t, m), generator=g, device=cuda) < 0.6).float()
    masks[0] = 1.0
    g_mu, g_lv = torch.randn((2, t, b, d), generator=g, device=cuda)
    return mu, lv, masks, g_mu, g_lv


@pytest.mark.parametrize("t,m,b", POE_CASES)
def test_poe_kernel_matches_plain(cuda, t, m, b):
    g = torch.Generator(device=cuda).manual_seed(t * 10 + m)
    mu = torch.randn((m, b, 100), generator=g, device=cuda)
    lv = torch.randn((m, b, 100), generator=g, device=cuda)
    masks = (torch.rand((t, m), generator=g, device=cuda) < 0.6).float()
    n = ops.poe_fwd.launches
    k_mu, k_lv = ops.masked_poe_all_terms(mu, lv, masks)
    torch.cuda.synchronize()
    assert ops.poe_fwd.launches == n + 1
    p_mu, p_lv = poe_plain(mu, lv, masks)
    torch.testing.assert_close(k_mu, p_mu, **POE_TOL)
    torch.testing.assert_close(k_lv, p_lv, **POE_TOL)


@pytest.mark.parametrize("t,m,b,d", [c + (100,) for c in POE_CASES]
                         + POE_RAGGED)
def test_poe_bwd_kernel_matches_plain(cuda, t, m, b, d):
    mu, lv, masks, g_mu, g_lv = _poe_inputs(cuda, t, m, b, d)
    n = ops.poe_bwd.launches
    k_dmu, k_dlv = ops.poe_bwd(mu, lv, masks, g_mu, g_lv)
    torch.cuda.synchronize()
    assert ops.poe_bwd.launches == n + 1
    assert k_dmu.shape == k_dlv.shape == mu.shape
    p_dmu, p_dlv = poe_bwd_plain(mu, lv, masks, g_mu, g_lv)
    torch.testing.assert_close(k_dmu, p_dmu, **POE_TOL)
    torch.testing.assert_close(k_dlv, p_dlv, **POE_TOL)
    k_mu, k_lv = ops.poe_fwd(mu, lv, masks)
    p_mu, p_lv = poe_plain(mu, lv, masks)
    torch.testing.assert_close(k_mu, p_mu, **POE_TOL)
    torch.testing.assert_close(k_lv, p_lv, **POE_TOL)


@pytest.mark.parametrize("t,m,b,d", [c + (100,) for c in POE_CASES]
                         + POE_RAGGED)
def test_poe_kernels_are_the_same_from_run_to_run(cuda, t, m, b, d):
    """Each output is written by one thread: two launches of either
    kernel give bit-identical results."""
    mu, lv, masks, g_mu, g_lv = _poe_inputs(cuda, t, m, b, d)
    for kern, args in ((ops.poe_fwd, (mu, lv, masks)),
                       (ops.poe_bwd, (mu, lv, masks, g_mu, g_lv))):
        first = kern(*args)
        for one, two in zip(first, kern(*args)):
            assert torch.equal(one, two)


def test_poe_kernels_take_a_view_off_a_16_byte_boundary(cuda):
    """mu one element past a 16-byte boundary: both kernels load by
    element and still match the plain versions."""
    mu, lv, masks, g_mu, g_lv = _poe_inputs(cuda, 3, 2, 100)
    buf = torch.empty(mu.numel() + 1, device=cuda)
    off = buf[1:].view(mu.shape)
    off.copy_(mu)
    assert off.data_ptr() % 16 != 0
    for got, want in ((ops.poe_fwd(off, lv, masks), poe_plain(mu, lv, masks)),
                      (ops.poe_bwd(off, lv, masks, g_mu, g_lv),
                       poe_bwd_plain(mu, lv, masks, g_mu, g_lv))):
        for k, p in zip(got, want):
            torch.testing.assert_close(k, p, **POE_TOL)


# (N, Nt, K, logits' dtype, targets' dtype) of the BCE kernel's cases
BCE_CASES = [
    (300, 300, 12288, torch.float32, torch.float32),
    (300, 300, 12288, torch.float32, torch.bfloat16),
    (300, 100, 12288, torch.float32, torch.bfloat16),   # shared targets
    (300, 100, 12288, torch.bfloat16, torch.bfloat16),  # the train step's
    (300, 100, 18, torch.float32, torch.float32),       # unaligned rows
    (8, 8, 12288, torch.bfloat16, torch.bfloat16),
    (8, 4, 12290, torch.bfloat16, torch.float32),       # scalar path
    (300, 100, 12296, torch.float32, torch.bfloat16),   # K off the split
    (7, 7, 1, torch.float32, torch.float32),            # K = 1
    (1, 1, 12288, torch.bfloat16, torch.bfloat16),      # N = 1
    (9, 3, 128, torch.float32, torch.float32),          # 32 chunks: narrow
    (5, 5, 132, torch.float32, torch.float32),          # 33 chunks: wide
    (4, 4, 50000, torch.bfloat16, torch.bfloat16),      # a cluster of 3,
                                                        # K off its spans
    (300, 100, 2500, torch.bfloat16, torch.bfloat16),   # MultiMNIST's
    (300, 100, 2500, torch.float32, torch.bfloat16),    # steps (element
    (10000, 100, 2500, torch.float32, torch.float32),   # loads) and IWAE
    (2100, 100, 12288, torch.bfloat16, torch.bfloat16),  # celeba19's step
    # vision: the bf16 step's 350 rows against 50 targets, 12288 and 4096
    # wide (and 4096 under --f32), the joint eval, the IWAE's chunk
    (350, 50, 12288, torch.bfloat16, torch.bfloat16),
    (350, 50, 4096, torch.bfloat16, torch.bfloat16),
    (350, 50, 4096, torch.float32, torch.float32),
    (50, 50, 4096, torch.float32, torch.bfloat16),
    (50, 50, 12288, torch.float32, torch.bfloat16),
    (5000, 50, 4096, torch.float32, torch.float32),
    (5000, 50, 12288, torch.float32, torch.float32),
]
# the bf16-math mode (bf16 logits): celeba19's train step (2100 image rows
# against 100 targets; the 18-wide attribute rows), MultiMNIST's 2500
# pixels and targets in f32. Each element equals the plain version's bit
# for bit (the precise expf and log1pf, as PyTorch's bf16 ops take them);
# the row sums differ in order only, at BCE_TOL
BCE_BF16_CASES = [
    (2100, 100, 12288, torch.bfloat16, torch.bfloat16),
    (2100, 100, 18, torch.bfloat16, torch.bfloat16),
    (300, 100, 2500, torch.bfloat16, torch.float32),
]


def _bce_inputs(cuda, n, nt, k, x_dt, t_dt, offset=0):
    """Logits starting `offset` elements into their buffer, and targets."""
    g = torch.Generator(device=cuda).manual_seed(3)
    buf = 3 * torch.randn(n * k + offset, generator=g, device=cuda)
    x = buf.to(x_dt)[offset:].view(n, k)
    t = torch.rand((nt, k), generator=g, device=cuda).to(t_dt)
    return x, t


@pytest.mark.parametrize("n,nt,k,x_dt,t_dt", BCE_CASES)
def test_bce_kernel_matches_plain(cuda, n, nt, k, x_dt, t_dt):
    x, t = _bce_inputs(cuda, n, nt, k, x_dt, t_dt)
    got = ops.bce_sum(x, t)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, bce_rowsum_plain(x, t), **BCE_TOL)


@pytest.mark.parametrize("offset", [1, 3])
@pytest.mark.parametrize("x_dt", [torch.float32, torch.bfloat16])
def test_bce_kernel_takes_a_view_off_a_16_byte_boundary(cuda, x_dt, offset):
    """Logits `offset` elements past a 16-byte boundary load element by
    element, and still match the plain version."""
    x, t = _bce_inputs(cuda, 300, 100, 12288, x_dt, torch.bfloat16, offset)
    assert x.data_ptr() % 16 != 0
    got = ops.bce_rowsum_fwd(x, t)
    torch.testing.assert_close(got, bce_rowsum_plain(x, t), **BCE_TOL)


@pytest.mark.parametrize("n,nt,k,x_dt,t_dt", BCE_CASES)
def test_bce_kernel_is_the_same_from_run_to_run(cuda, n, nt, k, x_dt, t_dt):
    """Two launches give bit-identical row sums: the blocks of a row are
    added in rank order."""
    x, t = _bce_inputs(cuda, n, nt, k, x_dt, t_dt)
    first = ops.bce_rowsum_fwd(x, t)
    for _ in range(3):
        assert torch.equal(ops.bce_rowsum_fwd(x, t), first)


@pytest.mark.parametrize("n,nt,k,x_dt,t_dt", BCE_BF16_CASES)
def test_bce_bf16_math_matches_plain_and_reruns(cuda, n, nt, k, x_dt, t_dt):
    """bf16_math: the kernel against its plain version's bf16 steps, one
    launch, bit-identical on a rerun, and apart from the f32 math."""
    x, t = _bce_inputs(cuda, n, nt, k, x_dt, t_dt)
    before = ops.bce_rowsum_fwd.launches
    got = ops.bce_sum(x, t, bf16_math=True)
    torch.cuda.synchronize()
    assert ops.bce_rowsum_fwd.launches == before + 1
    torch.testing.assert_close(got, bce_rowsum_plain(x, t, True), **BCE_TOL)
    assert torch.equal(ops.bce_rowsum_fwd(x, t, True), got)
    assert not torch.equal(ops.bce_rowsum_fwd(x, t), got)


def _strided(x):
    """x's values and shape in a non-contiguous layout."""
    return x.transpose(1, 2).contiguous().transpose(1, 2)


def test_kernel_wrappers_reject_what_they_do_not_take(cuda):
    x = torch.zeros((4, 8), device=cuda)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ops.bce_rowsum_fwd(x.half(), x)
    with pytest.raises(ValueError, match="contiguous"):
        ops.bce_rowsum_fwd(torch.zeros((8, 4), device=cuda).t(), x)
    m = torch.zeros((33, 2, 3), device=cuda)
    g = torch.zeros((1, 2, 3), device=cuda)
    with pytest.raises(ValueError, match="experts"):
        ops.poe_fwd(m, m, torch.ones((1, 33), device=cuda))
    with pytest.raises(ValueError, match="experts"):
        ops.poe_bwd(m, m, torch.ones((1, 33), device=cuda), g, g)
    mu, lv, masks, g_mu, g_lv = _poe_inputs(cuda, 3, 2, 4, 8)
    for bad, what in (
            ((mu.double(), lv, masks, g_mu, g_lv), "float32"),
            ((mu, lv, masks, g_mu.half(), g_lv), "float32"),
            ((_strided(mu), lv, masks, g_mu, g_lv), "contiguous"),
            ((mu, lv, masks, _strided(g_mu), g_lv), "contiguous"),
            ((mu, lv, masks.cpu(), g_mu, g_lv), "one CUDA device"),
            ((mu, lv, masks, g_mu.cpu(), g_lv), "one CUDA device"),
            ((mu, lv, masks, g_mu[:2], g_lv), "gradients must be")):
        with pytest.raises(ValueError, match=what):
            ops.poe_bwd(*bad)
        if bad[3] is g_mu:
            with pytest.raises(ValueError, match=what):
                ops.poe_fwd(*bad[:3])


def _conv_inputs(cuda, shape, dtype, seed=0):
    b, c_in, h, c_out, _, _ = shape
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = (2 * torch.rand((b, c_in, h, h), generator=g, device=cuda)).to(dtype)
    w = (torch.randn((c_out, c_in, 4, 4), generator=g, device=cuda)
         / (16 * c_in) ** 0.5).to(dtype)
    return x, w


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", CONV_SHAPES)
def test_conv_moments_kernel_matches_plain(cuda, shape, dtype):
    """y, sum y and sum y^2 against the plain version (F.conv2d, then the
    sums of the rounded y), one launch; the sums also against the kernel's
    own y, whose moments they are by definition. In f32, and in bf16 at
    the first four shapes, the sums are held to the plain ones at
    CONV_SUM_TOL as it stands. At the other shapes in bf16 a channel may
    have few pixels (50 at (2, 16, 10, 40, 2, 1)), and one y that rounds
    its f32 accumulator to the bf16 neighbour of cuDNN's then moves the
    channel's mean by more than that: there each channel is allowed, on
    top of CONV_SUM_TOL, what its y differs from the plain y, summed over
    its pixels, which is 0 where the two y are equal."""
    x, w = _conv_inputs(cuda, shape, dtype)
    stride, pad = shape[4:]
    n = ops.conv2d_moments_fwd.launches
    y, s, q = convbn.conv2d_moments_fwd(x, w, stride, pad)
    torch.cuda.synchronize()
    assert ops.conv2d_moments_fwd.launches == n + 1
    py, ps, pq = convbn.conv2d_moments_plain(x, w, stride, pad)
    assert y.dtype == dtype and y.shape == py.shape
    torch.testing.assert_close(y.float(), py.float(), **CONV_Y_TOL[dtype])
    pixels = y.numel() // y.shape[1]
    yf, pyf = y.float(), py.float()
    torch.testing.assert_close(
        torch.stack((s, q)) / pixels,
        torch.stack((yf.sum(dim=(0, 2, 3)), (yf * yf).sum(dim=(0, 2, 3))))
        / pixels, rtol=1e-5, atol=1e-6)
    got = torch.stack((s, q)) / pixels
    want = torch.stack((ps, pq)) / pixels
    if dtype == torch.float32 or shape in CONV_SHAPES_STRICT:
        torch.testing.assert_close(got, want, **CONV_SUM_TOL[dtype])
        return
    moved = torch.stack(((yf - pyf).abs().sum(dim=(0, 2, 3)),
                         (yf * yf - pyf * pyf).abs().sum(dim=(0, 2, 3))))
    tol = CONV_SUM_TOL[dtype]
    limit = tol["atol"] + tol["rtol"] * want.abs() + moved / pixels
    gap = (got - want).abs()
    assert (gap <= limit).all(), (gap.max().item(), (gap - limit).max().item(),
                                  int((yf != pyf).sum()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [CONV_SHAPES[0], CONV_SHAPES[2],
                                   CONV_SHAPES[9]] + CONV_VISION)
def test_conv_moments_is_the_same_from_run_to_run(cuda, shape, dtype):
    """Two launches on the same inputs give bit-identical y and sums: the
    partial sums are added in tile order, whichever block finishes last."""
    x, w = _conv_inputs(cuda, shape, dtype, seed=5)
    stride, pad = shape[4:]
    first = convbn.conv2d_moments_fwd(x, w, stride, pad)
    for _ in range(3):
        again = convbn.conv2d_moments_fwd(x, w, stride, pad)
        for got, want in zip(again, first):
            assert torch.equal(got, want)


def test_conv_moments_carries_gradients_on_the_card(cuda):
    """The op's outputs on the kernel are part of the autograd graph; dx
    and dw of a loss through all three equal the plain versions' (the same
    stock backward on a dy folded from y's within tolerance of each
    other), f32."""
    x, w = _conv_inputs(cuda, CONV_SHAPES[1], torch.float32, seed=3)
    grads = []
    for plain in (False, True):
        xi, wi = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        before = ops.conv2d_moments_fwd.launches
        with ops.plain_versions() if plain else contextlib.nullcontext():
            y, s, q = ops.conv2d_moments(xi, wi, 2, 1)
        assert (ops.conv2d_moments_fwd.launches != before) != plain
        assert y.requires_grad and s.requires_grad and q.requires_grad
        (y.square().mean() + s.mean() * 1e-3 + q.mean() * 1e-4).backward()
        grads.append((xi.grad, wi.grad))
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-6)


def test_conv_moments_wrapper_rejects_what_it_does_not_take(cuda):
    x, w = _conv_inputs(cuda, CONV_SHAPES[1], torch.float32)
    with pytest.raises(ValueError, match="4x4 kernels"):
        convbn.conv2d_moments_fwd(x[:, :, :15, :15].contiguous(), w, 2, 1)
    with pytest.raises(ValueError, match="4x4 kernels"):
        convbn.conv2d_moments_fwd(x, w, 2, 0)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        convbn.conv2d_moments_fwd(x, w.bfloat16(), 2, 1)
    with pytest.raises(ValueError, match="contiguous"):
        convbn.conv2d_moments_fwd(x.transpose(2, 3), w, 2, 1)


def _batch(cuda, b=4):
    rng = np.random.default_rng(0)
    return {"image": torch.from_numpy(rng.integers(
                0, 256, (b, 64, 64, 3), dtype=np.uint8)).to(cuda),
            "attrs": torch.from_numpy((rng.random((b, 18)) < 0.3)
                                      .astype(np.float32)).to(cuda)}


def test_eval_step_goes_through_the_kernels(cuda):
    """One PoE launch and two BCE launches per eval step; the result equals
    the same step on the plain versions (f32, TF32 off) at rtol 1e-4 and
    the same step on the CPU at rtol 1e-4."""
    model = CelebaMVAE(8, device=cuda)
    batch = _batch(cuda)
    step = make_eval_step(model, MASKS, LAMBDAS)
    ops.reset_launch_counts()
    total, per_term = step(batch)
    want = {k: 0 for k in ops.KERNELS} | {"poe_fwd": 1, "poe_bwd": 0,
                                          "bce_rowsum_fwd": 2}
    assert ops.launch_counts() == want
    with ops.plain_versions():
        p_total, p_terms = step(batch)
    assert ops.launch_counts() == want
    torch.testing.assert_close(per_term, p_terms, rtol=1e-4, atol=0)
    torch.testing.assert_close(total, p_total, rtol=1e-4, atol=0)
    cpu = CelebaMVAE(8, device="cpu")
    c_total, c_terms = make_eval_step(cpu, MASKS, LAMBDAS, device="cpu")(
        {k: v.cpu() for k, v in batch.items()})
    torch.testing.assert_close(per_term.cpu(), c_terms, rtol=1e-4, atol=0)


def test_embed_is_one_poe_launch(cuda):
    sampler = Sampler(CelebaMVAE(8, device=cuda))
    ops.reset_launch_counts()
    mu, _ = sampler.embed({"attrs": np.zeros((3, 18), np.float32)})
    assert mu.shape == (3, 8) and mu.is_cuda
    assert ops.launch_counts() == {k: 0 for k in ops.KERNELS} | {
        "poe_fwd": 1, "poe_bwd": 0}


def _bn_inputs(cuda, shape, dtype, seed, offset=0):
    """x4 (starting `offset` elements into its buffer), g4, scale, bias."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    gsz, n, c, sp = shape
    numel = gsz * n * c * sp
    buf = 0.5 + 1.5 * torch.randn(numel + offset, generator=g, device=cuda)
    x4 = buf.to(dtype)[offset:].view(shape)
    g4 = torch.randn(shape, generator=g, device=cuda).to(dtype)
    scale = 1.0 + 0.2 * torch.randn(c, generator=g, device=cuda)
    bias = 0.2 * torch.randn(c, generator=g, device=cuda)
    return x4, g4, scale, bias


def _bn_passes_match_plain(x4, g4, scale, bias):
    """Each of the four BN passes against its plain version on the same
    inputs: the sums as means at BN_SUM_TOL, y and dx at BN_OUT_TOL, the
    (G, C) and (C,) outputs at BN_SUM_TOL; one launch each."""
    dtype = x4.dtype
    m = x4.shape[1] * x4.shape[3]
    before = ops.launch_counts()
    s_k = torch.stack(bn_ops.bn_moments(x4)) / m
    s, q = bn_ops.bn_moments_plain(x4)
    torch.testing.assert_close(s_k, torch.stack((s, q)) / m, **BN_SUM_TOL)
    got = bn_ops.bn_normalize(x4, s, q, m, scale, bias)
    want = bn_ops.bn_normalize_plain(x4, s, q, m, scale, bias)
    assert got[0].dtype == dtype and got[0].shape == x4.shape
    torch.testing.assert_close(got[0].float(), want[0].float(),
                               **BN_OUT_TOL[dtype])
    for k, p in zip(got[1:], want[1:]):
        torch.testing.assert_close(k, p, **BN_SUM_TOL)
    _, mean, _, a, b, invstd = want
    p_k = torch.stack(bn_ops.bn_bwd_partials(x4, g4, a, b)) / m
    sdz, sdzx = bn_ops.bn_bwd_partials_plain(x4, g4, a, b)
    torch.testing.assert_close(p_k, torch.stack((sdz, sdzx)) / m,
                               **BN_SUM_TOL)
    got = bn_ops.bn_dx(x4, g4, sdz, sdzx, m, a, b, mean, invstd)
    want = bn_ops.bn_dx_plain(x4, g4, sdz, sdzx, m, a, b, mean, invstd)
    assert got[0].dtype == dtype and got[0].shape == x4.shape
    torch.testing.assert_close(got[0].float(), want[0].float(),
                               **BN_OUT_TOL[dtype])
    sdzxh = bn_ops.bn_dx_coeffs(sdz, sdzx, m, a, mean, invstd)[0]
    for k, p, terms in zip(got[1:], want[1:], (sdzxh, sdz)):
        if x4.shape[0] <= 3:
            torch.testing.assert_close(k, p, **BN_SUM_TOL)
        else:
            bound = BN_SUM_TOL["atol"] + GROUP_SUM_RTOL * terms.abs().sum(0)
            assert ((k - p).abs() <= bound).all(), (k - p).abs().max()
    torch.cuda.synchronize()
    after = ops.launch_counts()
    for k in ("bn_moments", "bn_normalize", "bn_bwd_partials", "bn_dx"):
        assert after[k] == before[k] + 1, k


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", BN_SHAPES)
def test_bn_kernels_match_plain(cuda, shape, dtype):
    """Each of the four BN passes against its plain version at every BN
    shape of the train step and at ragged ones, both dtypes: S below 16
    bytes takes bn_bwd_partials' columns mapping, and the chunks of
    bn_normalize's and bn_dx's stream cross channels where S is not a
    multiple of the chunk (S = 1, 3, 25)."""
    _bn_passes_match_plain(*_bn_inputs(cuda, shape, dtype, sum(shape)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,offset", [
    ((3, 100, 32, 1024), 1), ((1, 100, 512, 1), 1), ((1, 5, 7, 1), 1),
    ((2, 3, 4, 25), 3), ((3, 7, 9, 5), 1), ((2, 40, 4000, 1), 0),
    ((2, 40, 4000, 1), 1)])
def test_bn_stream_kernels_take_any_start_and_length(cuda, shape, offset,
                                                     dtype):
    """x starting `offset` elements past a 16-byte boundary (2 or 6 bytes
    in bf16: the stream's head; its output is allocated at the same
    offset), odd numels (its tail), and (G, C) = (2, 4000), against the
    plain versions."""
    x4, g4, scale, bias = _bn_inputs(cuda, shape, dtype, 7, offset)
    assert (x4.data_ptr() % 16 != 0) == (offset != 0)
    _bn_passes_match_plain(x4, g4, scale, bias)


@pytest.mark.parametrize("op", ["moments", "partials"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", BN_SHAPES)
def test_bn_bwd_partials_is_the_same_from_run_to_run(cuda, shape, dtype, op):
    """Both reductions (bn_moments, bn_bwd_partials): two launches on the
    same inputs give bit-identical sums, as the blocks of a plane are
    added in rank order."""
    g = torch.Generator(device=cuda).manual_seed(11)
    x4 = torch.randn(shape, generator=g, device=cuda).to(dtype)
    g4 = torch.randn(shape, generator=g, device=cuda).to(dtype)
    a = 1.0 + 0.2 * torch.randn((shape[0], shape[2]), generator=g,
                                device=cuda)
    b = 0.2 * torch.randn((shape[0], shape[2]), generator=g, device=cuda)

    def run():
        if op == "moments":
            return bn_ops.bn_moments(x4)
        return bn_ops.bn_bwd_partials(x4, g4, a, b)

    first = run()
    for _ in range(3):
        again = run()
        assert torch.equal(again[0], first[0])
        assert torch.equal(again[1], first[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [BN_SHAPES[6], BN_SHAPES[7],
                                   BN_SHAPES[2], BN_SHAPES[9],
                                   (1, 50, 256, 25), (7, 50, 32, 1024)])
def test_bn_stream_kernels_are_the_same_from_run_to_run(cuda, shape, dtype):
    """bn_normalize and bn_dx launched twice give bit-identical outputs,
    the (G, C) vectors too: one block writes them, in a fixed order."""
    x4, g4, scale, bias = _bn_inputs(cuda, shape, dtype, 12)
    m = shape[1] * shape[3]
    s, q = bn_ops.bn_moments(x4)
    first = bn_ops.bn_normalize(x4, s, q, m, scale, bias)
    _, mean, _, a, b, invstd = first
    sdz, sdzx = bn_ops.bn_bwd_partials(x4, g4, a, b)
    first_dx = bn_ops.bn_dx(x4, g4, sdz, sdzx, m, a, b, mean, invstd)
    for _ in range(2):
        for got, want in zip(bn_ops.bn_normalize(x4, s, q, m, scale, bias),
                             first):
            assert torch.equal(got, want)
        for got, want in zip(bn_ops.bn_dx(x4, g4, sdz, sdzx, m, a, b, mean,
                                          invstd), first_dx):
            assert torch.equal(got, want)


# the cells' channels-last planes as the BN op views them, (G, N*H*W, C,
# 1) bf16: CelebA's decoder convT3 at B = 4096 for the live terms and the
# dead one, its encoder's conv2 and conv4, celeba19's dead terms at
# B = 2048 (2.4 GB); then an f32 plane of 512 channels (BatchNorm1d's
# width) at 16384 rows
NHWC_PLANES = [(2, 4096 * 1024, 32, 1), (1, 4096 * 1024, 32, 1),
               (1, 4096 * 256, 64, 1), (1, 4096 * 25, 256, 1),
               (18, 2048 * 1024, 32, 1)]


@pytest.mark.parametrize("shape", NHWC_PLANES + [(1, 16384, 512, 1)])
def test_bn_lanes_kernels_match_plain_at_the_cells_planes(cuda, shape):
    """The four passes' lanes forms (a channels-innermost plane: the lanes
    reductions over many blocks in clusters, the lanes streams) against
    their plain versions at the cells' planes, one launch each."""
    dtype = torch.float32 if shape[2] == 512 else torch.bfloat16
    isz = 4 if dtype == torch.float32 else 2
    assert bn_ops.reduce_launch(*shape, isz, True, 2)["columns"] == 2
    assert bn_ops.normalize_launch(*shape, isz)["lanes"]
    assert bn_ops.dx_launch(*shape, isz)["lanes"]
    _bn_passes_match_plain(*_bn_inputs(cuda, shape, dtype, 21))
    torch.cuda.empty_cache()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [NHWC_PLANES[0], NHWC_PLANES[3],
                                   (18, 64 * 1024, 32, 1),
                                   (3, 8192, 96, 1), (1, 8192, 64, 1)])
def test_bn_lanes_kernels_are_the_same_from_run_to_run(cuda, shape, dtype):
    """The lanes forms launched again on the same inputs give bit-identical
    outputs: the reductions add their blocks, clusters and runs in a fixed
    order; the counters each launch leaves at 0 let the next one count."""
    x4, g4, scale, bias = _bn_inputs(cuda, shape, dtype, 22)
    m = shape[1]
    first = [bn_ops.bn_moments(x4)]
    s, q = first[0]
    first.append(bn_ops.bn_normalize(x4, s, q, m, scale, bias))
    _, mean, _, a, b, invstd = first[1]
    first.append(bn_ops.bn_bwd_partials(x4, g4, a, b))
    sdz, sdzx = first[2]
    first.append(bn_ops.bn_dx(x4, g4, sdz, sdzx, m, a, b, mean, invstd))
    for _ in range(2):
        again = (bn_ops.bn_moments(x4),
                 bn_ops.bn_normalize(x4, s, q, m, scale, bias),
                 bn_ops.bn_bwd_partials(x4, g4, a, b),
                 bn_ops.bn_dx(x4, g4, sdz, sdzx, m, a, b, mean, invstd))
        for got, want in zip(again, first):
            for one, two in zip(got, want):
                assert torch.equal(one, two)
    torch.cuda.empty_cache()


def test_bn_channels_last_layer_is_four_launches_on_the_card(cuda):
    """A channels-last train-mode BN layer (G = 3, bf16, 16384 rows a group:
    the lanes forms) with a channels-last upstream gradient, as a conv's
    dgrad gives it: the four BN kernels once each and no other kernel on
    the card, no copy on either side; y and dx channels-last."""
    from torch.profiler import ProfilerActivity, profile
    g = torch.Generator(device=cuda).manual_seed(14)
    cl = torch.channels_last
    x = torch.randn((3 * 64, 32, 16, 16), generator=g, device=cuda
                    ).bfloat16().contiguous(memory_format=cl)
    ct = torch.randn(x.shape, generator=g, device=cuda
                     ).bfloat16().contiguous(memory_format=cl)

    def layer():
        xi = x.clone().requires_grad_(True)
        w = torch.ones(32, device=cuda, requires_grad=True)
        b = torch.zeros(32, device=cuda, requires_grad=True)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            y, _, _ = ops.bn_swish_train(xi, w, b, groups=3)
            y.backward(ct)
            torch.cuda.synchronize()
        assert y.is_contiguous(memory_format=cl) and not y.is_contiguous()
        assert xi.grad.is_contiguous(memory_format=cl)
        return [e.key for e in prof.key_averages()
                for _ in range(e.count)
                if e.device_type == torch.autograd.DeviceType.CUDA]

    layer()
    before = ops.launch_counts()
    kernels = layer()
    after = ops.launch_counts()
    for k in ("bn_moments", "bn_normalize", "bn_bwd_partials", "bn_dx"):
        assert after[k] == before[k] + 1, k
    stems = ("MomentsOp", "bn_normalize_kernel_lanes", "PartialsOp",
             "bn_dx_kernel_lanes")
    for stem in stems:
        assert sum(stem in k for k in kernels) == 1, (stem, kernels)
    assert sum("bn_reduce_kernel_lanes" in k for k in kernels) == 2
    others = [k for k in kernels if not any(s in k for s in stems)]
    assert not others, others


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bn_op_autograd_on_channels_last_card_tensors(cuda, dtype):
    """bn_swish_train on a channels-last map through the kernels' lanes
    forms: y, the moments and the gradients of x, scale and bias against
    the same call on the plain versions, G = 3 (the decoder's grouping),
    8192 rows a group."""
    g = torch.Generator(device=cuda).manual_seed(5)
    cl = torch.channels_last
    x = torch.randn((3 * 32, 32, 16, 16), generator=g, device=cuda
                    ).to(dtype).contiguous(memory_format=cl)
    ct = torch.randn(x.shape, generator=g, device=cuda
                     ).to(dtype).contiguous(memory_format=cl)
    outs = []
    for plain in (False, True):
        xi = x.clone().requires_grad_(True)
        w = torch.ones(32, device=cuda, requires_grad=True)
        b = torch.zeros(32, device=cuda, requires_grad=True)
        with ops.plain_versions() if plain else contextlib.nullcontext():
            y, mean, var = ops.bn_swish_train(xi, w, b, groups=3)
            y.backward(ct)
        assert y.is_contiguous(memory_format=cl)
        outs.append((y, mean, var, xi.grad, w.grad, b.grad))
    tol = (dict(rtol=1e-4, atol=1e-5) if dtype == torch.float32
           else dict(rtol=2 ** -7, atol=1e-4))
    for got, want in zip(*outs):
        torch.testing.assert_close(got.float(), want.float(), **tol)


def test_bn_layer_is_four_launches_on_the_card(cuda):
    """One train-mode BN layer's forward and backward (G = 3, bf16) run
    the port's four BN kernels once each and no other kernel on the card:
    the per-channel algebra between them is inside bn_normalize and bn_dx
    (torch.profiler's CUDA kernel events; autograd's accumulation of the
    gradients into fresh .grad tensors launches nothing)."""
    from torch.profiler import ProfilerActivity, profile
    g = torch.Generator(device=cuda).manual_seed(13)
    x = torch.randn((3 * 10, 32, 16, 16), generator=g,
                    device=cuda).bfloat16()
    ct = torch.randn(x.shape, generator=g, device=cuda).bfloat16()

    def layer():
        xi = x.clone().requires_grad_(True)
        w = torch.ones(32, device=cuda, requires_grad=True)
        b = torch.zeros(32, device=cuda, requires_grad=True)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            y, _, _ = ops.bn_swish_train(xi, w, b, groups=3)
            y.backward(ct)
            torch.cuda.synchronize()
        assert xi.grad is not None and w.grad is not None
        return [e.key for e in prof.key_averages()
                for _ in range(e.count)
                if e.device_type == torch.autograd.DeviceType.CUDA]

    layer()
    before = ops.launch_counts()
    kernels = layer()
    after = ops.launch_counts()
    for k in ("bn_moments", "bn_normalize", "bn_bwd_partials", "bn_dx"):
        assert after[k] == before[k] + 1, k
    stems = ("MomentsOp", "bn_normalize_kernel", "PartialsOp",
             "bn_dx_kernel")
    for stem in stems:
        assert sum(stem in k for k in kernels) == 1, (stem, kernels)
    others = [k for k in kernels if not any(s in k for s in stems)]
    assert not others, others


def test_bn_op_autograd_on_the_card_matches_plain(cuda):
    """bn_swish_train through its kernels: y, the moments and the
    gradients of x, scale and bias against the same call on the plain
    versions, f32, G = 3 (the decoder's grouping)."""
    g = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn((3 * 6, 32, 8, 8), generator=g, device=cuda)
    ct = torch.randn(x.shape, generator=g, device=cuda)
    outs = []
    for plain in (False, True):
        xi = x.clone().requires_grad_(True)
        w = torch.ones(32, device=cuda, requires_grad=True)
        b = torch.zeros(32, device=cuda, requires_grad=True)
        with ops.plain_versions() if plain else contextlib.nullcontext():
            y, mean, var = ops.bn_swish_train(xi, w, b, groups=3)
            y.backward(ct)
        outs.append((y, mean, var, xi.grad, w.grad, b.grad))
    for got, want in zip(*outs):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


def test_poe_and_bce_carry_gradients_on_the_card(cuda):
    """The kernels' outputs are part of the autograd graph, and the
    gradients equal those of the plain versions (the backward is the same
    closed form; the forward is the kernel)."""
    g = torch.Generator(device=cuda).manual_seed(9)
    mu = torch.randn((2, 5, 8), generator=g, device=cuda)
    lv = torch.randn((2, 5, 8), generator=g, device=cuda)
    masks = torch.tensor(MASKS, device=cuda)
    x = torch.randn((6, 12288), generator=g, device=cuda).bfloat16()
    t = torch.rand((2, 12288), generator=g, device=cuda).bfloat16()
    grads = []
    for plain in (False, True):
        m_ = mu.clone().requires_grad_(True)
        l_ = lv.clone().requires_grad_(True)
        x_ = x.clone().requires_grad_(True)
        before = ops.launch_counts()
        with ops.plain_versions() if plain else contextlib.nullcontext():
            pd_mu, pd_lv = ops.masked_poe_all_terms(m_, l_, masks)
            rows = ops.bce_sum(x_, t)
        launched = ops.launch_counts() != before
        assert launched != plain
        assert pd_mu.requires_grad and pd_lv.requires_grad
        assert rows.requires_grad
        n = ops.poe_bwd.launches
        with ops.plain_versions() if plain else contextlib.nullcontext():
            (pd_mu.sum() + (pd_lv * pd_mu).sum() + rows.sum()).backward()
        assert ops.poe_bwd.launches == n + (not plain)
        grads.append((m_.grad, l_.grad, x_.grad))
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    assert grads[0][2].dtype == torch.bfloat16


def _one_step(model, batch, noise):
    model.train()
    model.zero_grad(set_to_none=True)
    dev = model.device
    total, _ = multi_term_elbo(model, batch, torch.tensor(MASKS, device=dev),
                               torch.tensor(LAMBDAS, device=dev), 1.0,
                               train=True, noise=noise)
    total.backward()
    return total.detach(), {k: p.grad.clone()
                            for k, p in model.named_parameters()}


def test_train_step_goes_through_all_eight_kernels(cuda):
    """One train-mode ELBO and its backward on the card, on the encoder's
    fused route: 1 PoE forward and 1 backward, 2 BCE launches, conv2d_moments once for each of the
    encoder's 3 BN'd convs, each BN pass once for each of the other 8 BN
    layers, and every parameter gradient within 1e-4 of the plain versions'
    in relative norm (f32, TF32 off). The Linear biases that feed a BN have
    an exact gradient of 0; both sides give rounding noise, held within
    1e-4 absolutely."""
    model = CelebaMVAE(8, conv_moments=True, device=cuda)
    twin = copy.deepcopy(model)
    batch = decode_batch(_batch(cuda))
    noise = draw_noise(model, 3, 4,
                       torch.Generator(device=cuda).manual_seed(1))
    ops.reset_launch_counts()
    total, grads = _one_step(model, batch, noise)
    torch.cuda.synchronize()
    assert ops.launch_counts() == {
        "poe_fwd": 1, "poe_bwd": 1, "bce_rowsum_fwd": 2, "bn_moments": 8,
        "bn_normalize": 8, "bn_bwd_partials": 8, "bn_dx": 8,
        "conv2d_moments": 3}
    with ops.plain_versions():
        p_total, p_grads = _one_step(twin, batch, noise)
    assert ops.launch_counts()["bn_dx"] == 8
    torch.testing.assert_close(total, p_total, rtol=1e-5, atol=0)
    noisy = {f"{name}.{i}.bias" for name, mod in model.named_modules()
             if isinstance(mod, torch.nn.Sequential)
             for i in range(len(mod) - 1)
             if isinstance(mod[i + 1], BatchNorm)
             and getattr(mod[i], "bias", None) is not None}
    assert len(noisy) == 5
    for k, want in p_grads.items():
        gap = (grads[k] - want).norm().item()
        if k in noisy:
            assert gap < 1e-4, (k, gap)
        else:
            assert gap < 1e-4 * want.norm().item(), (k, gap)


def test_multi_train_step_on_the_card(cuda):
    """K = 3 steps in bf16 from the device-resident uint8 data: a (3,)
    finite loss tensor on the card, moved parameters and running
    statistics."""
    model = CelebaMVAE(8, torch.bfloat16, device=cuda)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    multi = make_multi_train_step(
        model, MASKS, LAMBDAS, lr=1e-4,
        generator=torch.Generator(device=cuda).manual_seed(0))
    data = _batch(cuda, b=10)
    idxs = torch.tensor([[0, 1, 2, 3], [4, 5, 6, 7], [8, 9, 0, 1]],
                        device=cuda)
    losses = multi(data, idxs, torch.ones(3, device=cuda))
    assert losses.shape == (3,) and losses.is_cuda
    assert torch.isfinite(losses).all()
    for k, v in model.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert not torch.equal(v, before[k]), k


def _family_step(model, batch, masks, lambdas, noise, **kw):
    model.train()
    model.zero_grad(set_to_none=True)
    dev = model.device
    total, _ = multi_term_elbo(model, batch, torch.tensor(masks, device=dev),
                               torch.tensor(lambdas, device=dev), 1.0,
                               train=True, noise=noise, **kw)
    total.backward()
    return total.detach(), {k: p.grad.clone()
                            for k, p in model.named_parameters()}


def _grads_close(grads, p_grads):
    """Every gradient within 1e-4 of the plain versions' in relative norm
    (f32, TF32 off); the backward GRU's weight_hh meets h0 = 0 only, so
    both sides' are exactly 0."""
    for k, want in p_grads.items():
        gap = (grads[k] - want).norm().item()
        assert gap <= 1e-4 * want.norm().item(), (k, gap)


def test_multimnist_step_goes_through_the_kernels(cuda):
    """One MultiMNIST train-mode ELBO and its backward on the card, the
    encoder's conv3 on the fused route: 1 PoE forward and backward, 1 BCE
    launch (the text is a CE), conv2d_moments once (conv3), each BN pass
    once for each of the other 5 BN layers (S = 144, 4; 36, 144, 625);
    loss and gradients against the plain versions."""
    model = MultiMnistMVAE(8, conv_moments=True, device=cuda)
    twin = copy.deepcopy(model)
    rng = np.random.default_rng(0)
    batch = decode_batch({
        "image": torch.from_numpy(rng.integers(0, 256, (4, 50, 50, 1),
                                               dtype=np.uint8)).to(cuda),
        "text": torch.from_numpy(rng.integers(0, 12, (4, 4)).astype(
            np.int32)).to(cuda)})
    noise = draw_noise(model, 3, 4,
                       torch.Generator(device=cuda).manual_seed(1))
    assert len(noise) == 3
    ops.reset_launch_counts()
    total, grads = _family_step(model, batch, MASKS, LAMBDAS, noise)
    torch.cuda.synchronize()
    assert ops.launch_counts() == {
        "poe_fwd": 1, "poe_bwd": 1, "bce_rowsum_fwd": 1, "bn_moments": 5,
        "bn_normalize": 5, "bn_bwd_partials": 5, "bn_dx": 5,
        "conv2d_moments": 1}
    with ops.plain_versions():
        p_total, p_grads = _family_step(twin, batch, MASKS, LAMBDAS, noise)
    torch.testing.assert_close(total, p_total, rtol=1e-5, atol=0)
    _grads_close(grads, p_grads)


@pytest.mark.parametrize("fast", [False, True])
def test_celeba19_step_goes_through_the_kernels(cuda, fast):
    """One celeba19 train-mode ELBO at T = 21 (one sampled term) and its
    backward on the card: 1 PoE forward and backward at M = 19 (the expert
    cap 32), 1 BCE launch (the image rows; the attributes' scalar BCEs
    are elementwise), each BN pass once for each of the encoder's 3 and
    the decoder's 3 BN layers (G = 21, or G = 3 under --fast-term-decode);
    loss and gradients against the plain versions."""
    model = Celeba19MVAE(8, device=cuda)
    twin = copy.deepcopy(model)
    batch = decode_batch(_batch(cuda))
    masks, lambdas = celeba19_step_terms(np.random.default_rng(2), 1, 18,
                                         1.0, 10.0)
    kw = {}
    if fast:
        kw["plan"] = decode_plan(model, celeba19_recon_support(1),
                                 fast_skip_decode=True, device=cuda)
    noise = draw_noise(model, 21, 4,
                       torch.Generator(device=cuda).manual_seed(1))
    ops.reset_launch_counts()
    total, grads = _family_step(model, batch, masks, lambdas, noise, **kw)
    torch.cuda.synchronize()
    assert ops.launch_counts() == {
        "poe_fwd": 1, "poe_bwd": 1, "bce_rowsum_fwd": 1, "bn_moments": 6,
        "bn_normalize": 6, "bn_bwd_partials": 6, "bn_dx": 6,
        "conv2d_moments": 0}
    with ops.plain_versions():
        p_total, p_grads = _family_step(twin, batch, masks, lambdas, noise,
                                        **kw)
    torch.testing.assert_close(total, p_total, rtol=1e-5, atol=0)
    _grads_close(grads, p_grads)


def test_celeba19_iwae_goes_through_the_kernels(cuda):
    """The celeba19 IWAE (the loglike CLI's joint target: the image's and
    the attributes' row-summed BCEs) on the card: one PoE launch at M = 19,
    one BCE launch for each target input, and the estimate within rtol
    1e-5 of the plain versions'."""
    from mvae_tpu_torch.core.loglike import iwae_log_marginal
    model = Celeba19MVAE(8, device=cuda)
    batch = decode_batch(_batch(cuda))
    eps = torch.randn((3, 4, 8), device=cuda,
                      generator=torch.Generator(device=cuda).manual_seed(2))
    args = (model, batch, [1.0] * 19, list(model.loglike_targets), 3)
    ops.reset_launch_counts()
    got = iwae_log_marginal(*args, eps=eps)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts["poe_fwd"] == 1 and counts["bce_rowsum_fwd"] == 2
    with ops.plain_versions():
        want = iwae_log_marginal(*args, eps=eps)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0)


def _vision_batch(cuda, b=4):
    rng = np.random.default_rng(0)
    return {m: torch.from_numpy(rng.integers(
        0, 256, (b, 64, 64, CHANNELS[m]), dtype=np.uint8)).to(cuda)
        for m in MODALITIES}


VISION_TERMS = [[1.0] * 6] + [[float(i == j) for j in range(6)]
                              for i in range(6)]
VISION_LAMBDAS = [[1.0 / 6] * 6] * 7


@pytest.mark.parametrize("conv_moments", [False, True])
def test_vision_step_goes_through_the_kernels(cuda, conv_moments):
    """One vision train-mode ELBO at T = 7 with every modality
    reconstructed in every term, and its backward, on the card: 1 PoE
    forward and backward (M = 6, the expert cap 8), 6 BCE launches (rows
    of 12288 and of 4096), each BN pass once for each of the six
    decoders' 3 BN layers (G = 7) and, on the default route, the six
    encoders' 3, which the fused route gives to conv2d_moments (18
    launches); loss and gradients against the plain versions."""
    model = VisionMVAE(8, conv_moments=conv_moments, device=cuda)
    twin = copy.deepcopy(model)
    batch = decode_batch(_vision_batch(cuda))
    noise = draw_noise(model, 7, 4,
                       torch.Generator(device=cuda).manual_seed(1))
    rmasks = torch.ones((7, 6), device=cuda)
    ops.reset_launch_counts()
    total, grads = _family_step(model, batch, VISION_TERMS, VISION_LAMBDAS,
                                noise, recon_masks=rmasks)
    torch.cuda.synchronize()
    bn = 18 if conv_moments else 36
    assert ops.launch_counts() == {
        "poe_fwd": 1, "poe_bwd": 1, "bce_rowsum_fwd": 6, "bn_moments": bn,
        "bn_normalize": bn, "bn_bwd_partials": bn, "bn_dx": bn,
        "conv2d_moments": 36 - bn}
    with ops.plain_versions():
        p_total, p_grads = _family_step(twin, batch, VISION_TERMS,
                                        VISION_LAMBDAS, noise,
                                        recon_masks=rmasks)
    torch.testing.assert_close(total, p_total, rtol=1e-5, atol=0)
    _grads_close(grads, p_grads)


def test_vision_iwae_goes_through_the_kernels(cuda, monkeypatch):
    """The vision IWAE (joint: six row-summed BCEs) on the card, its
    samples decoded in two chunks: one PoE launch at M = 6, one BCE
    launch for each modality and chunk, and the estimate within rtol 1e-5
    of the plain versions'."""
    from mvae_tpu_torch.core import loglike
    model = VisionMVAE(8, device=cuda)
    batch = decode_batch(_vision_batch(cuda))
    eps = torch.randn((4, 4, 8), device=cuda,
                      generator=torch.Generator(device=cuda).manual_seed(2))
    monkeypatch.setattr(loglike, "DECODE_ELEMENTS", 2 * 4 * 49152)
    args = (model, batch, [1.0] * 6, list(MODALITIES), 4)
    ops.reset_launch_counts()
    got = loglike.iwae_log_marginal(*args, eps=eps)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts["poe_fwd"] == 1 and counts["bce_rowsum_fwd"] == 12
    with ops.plain_versions():
        want = loglike.iwae_log_marginal(*args, eps=eps)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bn_passes_under_a_one_rank_nccl_group_are_the_no_group_passes(
        cuda, dtype, tmp_path):
    """A process group of one NCCL rank: the BN op's all-reduces of its
    sums (forward and backward) and the fused route's differentiable one
    leave every output of the kernels bit for bit as without a group (the
    sum over one rank is the value; dscale and dbias, one rank's share,
    are the whole)."""
    import datetime
    import torch.distributed as dist
    from mvae_tpu_torch.nn.norm import bn_swish_from_moments
    from mvae_tpu_torch.parallel.collectives import all_reduce_sum
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=120))
    try:
        gen = torch.Generator(device=cuda).manual_seed(5)
        all_reduce_sum.calls = 0
        for g, n, c, s in [(1, 100, 64, 256), (3, 100, 128, 64),
                           (1, 100, 512, 1), (21, 100, 32, 1024)]:
            x = torch.randn((g * n, c, s), generator=gen, device=cuda)
            x = (x * 1.5 + 0.5).to(dtype)
            up = torch.randn(x.shape, generator=gen, device=cuda).to(dtype)
            scale = torch.rand(c, generator=gen, device=cuda) + 0.5
            bias = torch.randn(c, generator=gen, device=cuda) * 0.1
            outs = []
            for group in (None, dist.group.WORLD):
                xi = x.clone().requires_grad_()
                si, bi = (scale.clone().requires_grad_(),
                          bias.clone().requires_grad_())
                y, mean, var = bn_ops.bn_swish_train(xi, si, bi, g, group)
                y.backward(up)
                outs.append((y, mean, var, xi.grad, si.grad, bi.grad))
            for a, b in zip(*outs):
                assert torch.equal(a, b), (g, n, c, s)
        assert all_reduce_sum.calls == 2 * 4
        from mvae_tpu_torch.nn.norm import BatchNorm
        y = torch.randn((100, 64, 16, 16), generator=gen, device=cuda)
        outs = []
        for group in (None, dist.group.WORLD):
            bn = BatchNorm(64, device=cuda)
            bn.reset_parameters()
            bn.sync = group
            yi = y.clone().requires_grad_()
            s, q = yi.sum(dim=(0, 2, 3)), (yi * yi).sum(dim=(0, 2, 3))
            out = bn_swish_from_moments(bn, yi, s, q, dtype)
            out.float().backward(torch.ones_like(out, dtype=torch.float32))
            outs.append((out, yi.grad, bn.weight.grad, bn.bias.grad,
                         bn.moments.mean, bn.moments.var))
        for a, b in zip(*outs):
            assert torch.equal(a, b)
    finally:
        dist.destroy_process_group()


def test_bench_tool_reports_an_mfu_within_the_peak(cuda, capsys):
    """tools/bench.py on the card at --k 2 --windows 1: the reference
    flow in turns gives vs_baseline, the device metrics are read, and the
    step's share of the card's peak (mfu) lies in (0, 1.05]."""
    from mvae_tpu_torch.tools import bench
    out = bench.main(["--k", "2", "--windows", "1", "--warmup", "1"])
    assert out["device"]["name"] == torch.cuda.get_device_name(0)
    assert out["device"]["power_limit"]
    assert 0 < out["mfu"] <= 1.05
    assert 0 <= out["idle_share"] <= 1 and out["vs_baseline"] > 0
    assert out["launches_per_step"] > 0 and out["peak_mem_bytes"] > 0
    assert out["windows"]["count"] == 2
