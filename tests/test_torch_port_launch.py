"""The launch geometry of the port's redesigned kernels, held on the CPU:
what ops/convbn.py:launch_geometry, ops/bn.py:reduce_launch,
normalize_launch and dx_launch, ops/elbo.py:bce_launch and
ops/poe.py:expert_cap hand to csrc/conv_moments.cu, csrc/bn_swish.cu,
csrc/bce_rowsum.cu and csrc/poe.cu, and csrc/poe.cu's own grid. The
kernels themselves run only on a card
(tests/test_torch_port_cuda.py); their addressing is repeated here in
numpy, so that a geometry the kernel would read out of bounds, a tile that
misses a pixel, an element two threads write or an element given another
channel's coefficients fails here."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from mvae_tpu_torch.ops import bn as bn_ops
from mvae_tpu_torch.ops import convbn
from mvae_tpu_torch.ops import elbo
from mvae_tpu_torch.ops import poe

SM_COUNT = 132
MAX_SMEM = 232448
# (B, C_in, H, C_out, stride, padding): CelebA's three BN'd encoder convs
CELEBA = [(100, 32, 32, 64, 2, 1), (100, 64, 16, 128, 2, 1),
          (100, 128, 8, 256, 1, 0)]
# ragged and small: B = 1, M below one tile, C_out off the tile, rows of x
# that are not whole 16-byte chunks, C_in off the K slice
RAGGED = [(1, 32, 32, 64, 2, 1), (3, 3, 6, 8, 2, 1), (2, 16, 10, 40, 2, 1),
          (5, 3, 4, 96, 1, 0), (7, 16, 7, 40, 1, 0), (1, 5, 12, 8, 1, 0),
          (9, 6, 24, 33, 2, 1)]
# vision's three BN'd encoder convs at its batch of 50 (six encoders)
VISION = [(50, 32, 32, 64, 2, 1), (50, 64, 16, 128, 2, 1),
          (50, 128, 8, 256, 1, 0)]
DTYPES = [torch.bfloat16, torch.float32]


def _geometry(shape, dtype):
    b, c_in, h, c_out, stride, pad = shape
    return convbn.launch_geometry(b, c_in, h, h, c_out, stride, pad,
                                  torch.empty((), dtype=dtype).element_size())


def _stage(geo, x, tile, c0, stride, pad):
    """One stage's A tile as the kernel fills it (csrc/conv_moments.cu:
    tile_of, build_table, stage_a): (first padded row, flat array of kc *
    ch elements), zero wherever the kernel writes nothing."""
    b, c_in, h, w = x.shape
    oh = convbn.out_hw(h, stride, pad)
    ow = convbn.out_hw(w, stride, pad)
    m, vh = b * oh * ow, h + 2 * pad
    r0 = tile * geo["tile_m"] // ow
    r1 = (min((tile + 1) * geo["tile_m"], m) - 1) // ow
    v0 = r0 // oh * vh + r0 % oh * stride
    rows = r1 // oh * vh + r1 % oh * stride + 4 - v0
    assert rows <= geo["rows"]
    buf = np.zeros(geo["kc"] * geo["ch"], x.dtype)
    for c in range(geo["kc"]):
        if c0 + c >= c_in:
            continue
        for r in range(rows):
            bb, ih = divmod(v0 + r, vh)
            ih -= pad
            if 0 <= ih < h:
                at = c * geo["ch"] + r * geo["rs"] + geo["lp"]
                assert at + w <= (c + 1) * geo["ch"]
                buf[at:at + w] = x[bb, c0 + c, ih]
    return v0, buf


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", CELEBA + RAGGED + VISION)
def test_conv_stage_holds_every_window(shape, dtype):
    """Every element (pixel, ci, kh, kw) of the implicit im2col matrix is
    read from the staged tile at the offset the kernel computes
    (window_offset + ci * ch + kh * rs + kw), inside the stage, and equals
    the zero-padded x there; the bf16 fragment's second 4-byte word stays
    inside the stage too."""
    b, c_in, h, c_out, stride, pad = shape
    geo = _geometry(shape, dtype)
    itemsize = torch.empty((), dtype=dtype).element_size()
    rng = np.random.default_rng(sum(shape))
    x = rng.integers(1, 1000, (b, c_in, h, h)).astype(np.float32)
    xp = np.pad(x, ((0, 0), (0, 0), (pad, pad), (pad, pad)))
    oh = ow = convbn.out_hw(h, stride, pad)
    m, vh = b * oh * ow, h + 2 * pad
    assert geo["a_stage"] >= geo["kc"] * geo["ch"] * itemsize + 16
    assert geo["rs"] % 2 == 0 and geo["ch"] % (16 // itemsize) == 0
    tiles = sorted({0, geo["tiles"] // 2, geo["tiles"] - 1})
    for tile in tiles:
        for c0 in {0, (c_in - 1) // geo["kc"] * geo["kc"]}:
            v0, buf = _stage(geo, x, tile, c0, stride, pad)
            for mi in range(geo["tile_m"]):
                pix = min(tile * geo["tile_m"] + mi, m - 1)
                bb, r = divmod(pix, oh * ow)
                py, px = divmod(r, ow)
                off = ((bb * vh + py * stride - v0) * geo["rs"]
                       + px * stride + geo["lp"] - pad)
                for c in range(min(geo["kc"], c_in - c0)):
                    for kh in range(4):
                        at = off + c * geo["ch"] + kh * geo["rs"]
                        assert at >= c * geo["ch"]
                        assert at + 5 <= geo["a_stage"] // itemsize
                        np.testing.assert_array_equal(
                            buf[at:at + 4],
                            xp[bb, c0 + c, py * stride + kh,
                               px * stride:px * stride + 4])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", CELEBA + RAGGED + VISION)
def test_conv_grid_covers_the_output_once(shape, dtype):
    """tiles x n_tiles blocks of tile_m pixels x bn channels cover M x C_out
    exactly once; the shared memory fits a block; the scratch is what
    conv2d_moments_fwd allocates."""
    b, c_in, h, c_out, stride, pad = shape
    geo = _geometry(shape, dtype)
    oh = convbn.out_hw(h, stride, pad)
    m = b * oh * oh
    cover = np.zeros((m, c_out), np.int32)
    for t in range(geo["tiles"]):
        for n in range(geo["n_tiles"]):
            cover[t * geo["tile_m"]:(t + 1) * geo["tile_m"],
                  n * geo["bn"]:(n + 1) * geo["bn"]] += 1
    assert (cover == 1).all()
    assert (geo["tiles"] - 1) * geo["tile_m"] < m
    assert (geo["n_tiles"] - 1) * geo["bn"] < c_out
    assert geo["smem"] <= MAX_SMEM
    # a row of partial sums a tile, for sum y and for sum y^2
    assert geo["part"] == (2, geo["tiles"], c_out)
    # the stages, the epilogue's tile over them, the table, the alignment
    ring = geo["stages"] * (geo["atoms"] * geo["bn"] * 128 + geo["a_stage"])
    cs = geo["bn"] * (geo["tile_m"] + 4) * 4
    assert geo["smem"] >= 1024 + max(ring, cs) + 8 * geo["table"]
    assert geo["stages"] >= 3


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", CELEBA)
def test_conv_fills_the_card_at_celeba_shapes(shape, dtype):
    """At B = 100 every layer gets a block for each SM at least (bf16 a
        block and a half), copies whole 16-byte chunks, and all its blocks
        fit the card at once by their shared memory."""
    geo = _geometry(shape, dtype)
    blocks = geo["tiles"] * geo["n_tiles"]
    assert blocks >= SM_COUNT
    assert geo["vec"] == 1
    assert blocks <= SM_COUNT * (MAX_SMEM // geo["smem"])
    if dtype == torch.bfloat16:
        assert 2 * blocks >= 3 * SM_COUNT
        assert geo["bn"] in (32, 64) and geo["atoms"] in (1, 2)


def test_conv_geometry_is_what_the_wrapper_refuses_by():
    """A shape whose tile cannot fit a block's shared memory is refused by
    the wrapper's check, not handed on."""
    geo = convbn.launch_geometry(1, 1, 4, 60000, 1, 1, 0, 4)
    assert geo["smem"] > MAX_SMEM


# (G, N, C, S): the 8 + 3 BN layers of the CelebA train step, then ragged
BN_CELEBA = [(1, 100, 64, 256), (1, 100, 128, 64), (1, 100, 256, 25),
             (1, 100, 512, 1), (3, 100, 128, 64), (3, 100, 64, 256),
             (3, 100, 32, 1024), (3, 100, 512, 1)]
BN_RAGGED = [(1, 1, 7, 1), (2, 5, 40, 3), (1, 33, 50, 1), (2, 3, 4, 25),
             (1, 1000, 8, 16), (1, 2, 3, 200), (1, 1000, 20, 1),
             (3, 300, 9, 2)]
# the MultiMNIST train step's 3 + 3 BN layers (S = 144, 36, 4 in the
# encoder; 36, 144, 625 in the decoder, G = 3: planes whose bf16 S holds
# no whole 16-byte chunk but at 144), then celeba19's decoder at G = 21
BN_MULTIMNIST = [(1, 100, 64, 144), (1, 100, 128, 36), (1, 100, 256, 4),
                 (3, 100, 128, 36), (3, 100, 64, 144), (3, 100, 32, 625)]
BN_CELEBA19 = [(21, 100, 128, 64), (21, 100, 64, 256), (21, 100, 32, 1024)]
# vision's six encoders (B = 50) and six decoders (G = 7 terms)
BN_VISION = [(1, 50, 64, 256), (1, 50, 128, 64), (1, 50, 256, 25),
             (7, 50, 128, 64), (7, 50, 64, 256), (7, 50, 32, 1024)]
# vision's stacked modality groups: three modalities' channels side by side
BN_VISION += [(1, 50, 192, 256), (1, 50, 384, 64), (1, 50, 768, 25),
              (7, 50, 384, 64), (7, 50, 192, 256), (7, 50, 96, 1024)]


# the two reductions of csrc/bn_swish.cu by the tensors an element reads:
# bn_moments (x), bn_bwd_partials (x, g)
REDUCTIONS = {"moments": 1, "partials": 2}


def _reduce(shape, itemsize, op, aligned=(True, True)):
    """The geometry the op's wrapper asks for: 16-byte chunks only where
    every tensor it reads is aligned (ops/bn.py:_reduce_geometry)."""
    return bn_ops.reduce_launch(*shape, itemsize,
                                all(aligned[:REDUCTIONS[op]]),
                                REDUCTIONS[op])


@pytest.mark.parametrize("op", sorted(REDUCTIONS))
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", BN_CELEBA + BN_MULTIMNIST + BN_CELEBA19
                         + BN_RAGGED + BN_VISION)
def test_bn_bwd_partials_rows_in_exactly_one_block(shape, dtype, op):
    """Both reductions (bn_moments, bn_bwd_partials): every row of every
    plane lies in exactly one block, no block is empty, splits <= N and
    fit one cluster, and the columns mapping is chosen exactly when a run
    of S is shorter than 16 bytes; a block of SPLIT_THREADS only where the
    rows are split."""
    g, n, c, s = shape
    itemsize = torch.empty((), dtype=dtype).element_size()
    lay = _reduce(shape, itemsize, op)
    cover = np.zeros(n, np.int32)
    for y in range(lay["splits"]):
        lo, hi = y * lay["rows"], min(n, (y + 1) * lay["rows"])
        assert lo < hi
        cover[lo:hi] += 1
    assert (cover == 1).all()
    assert 1 <= lay["splits"] <= min(n, bn_ops.MAX_CLUSTER)
    assert lay["columns"] == int(s * itemsize < 16)
    assert lay["grid"][1] == lay["splits"]
    t, tpr = lay["threads"], lay["tpr"]
    assert t == (bn_ops.SPLIT_THREADS if lay["splits"] > 1
                 else bn_ops.PLANE_THREADS)
    assert tpr & (tpr - 1) == 0 and t % tpr == 0
    if lay["columns"]:
        assert tpr == bn_ops.COLUMNS_WIDE <= 32 and lay["vec"] == 1
        assert lay["grid"][0] == g * -(-c // tpr)
    else:
        assert lay["grid"][0] == g * c
        assert lay["vec"] in (1, 16 // itemsize) and s % lay["vec"] == 0


# whether each reduction splits its rows over a cluster at the BN layers of
# the CelebA train step (the geometry PERF.md's readings chose): a plain
# block at conv2-conv4 and convT1-convT2 for moments, at conv3 and convT1
# for partials, a split at the decoder's last BN for both; the S = 1
# layers (BatchNorm1d, f32) in a plain block each
CELEBA_SPLITS = {(1, 100, 64, 256): {"moments": False, "partials": True},
                 (1, 100, 128, 64): {"moments": False, "partials": False},
                 (1, 100, 256, 25): {"moments": False, "partials": True},
                 (1, 100, 512, 1): {"moments": False, "partials": False},
                 (3, 100, 128, 64): {"moments": False, "partials": False},
                 (3, 100, 64, 256): {"moments": False, "partials": True},
                 (3, 100, 32, 1024): {"moments": True, "partials": True},
                 (3, 100, 512, 1): {"moments": False, "partials": False}}


@pytest.mark.parametrize("op", sorted(REDUCTIONS))
@pytest.mark.parametrize("shape", BN_CELEBA)
def test_bn_bwd_partials_fills_the_card_at_celeba_shapes(shape, op):
    """Both reductions at the BN layers of the train step (bf16 maps with
    16-byte loads where S holds whole chunks; f32 at S = 1): each splits
    its rows over a cluster exactly where CELEBA_SPLITS says, a split grid
    holds at least two blocks an SM, and a plain one is one block of
    PLANE_THREADS a plane (a stretch of channels at S = 1)."""
    g, n, c, s = shape
    itemsize = 4 if s == 1 else 2
    lay = _reduce(shape, itemsize, op)
    if s > 1:
        assert lay["vec"] == (8 if s % 8 == 0 else 1)
    assert (lay["splits"] > 1) == CELEBA_SPLITS[shape][op]
    if lay["splits"] > 1:
        assert lay["threads"] == bn_ops.SPLIT_THREADS
        assert lay["grid"][0] * lay["grid"][1] >= 2 * SM_COUNT
    else:
        assert lay["threads"] == bn_ops.PLANE_THREADS
        assert lay["grid"][0] == (g * c if s > 1
                                  else g * -(-c // bn_ops.COLUMNS_WIDE))


@pytest.mark.parametrize("op", sorted(REDUCTIONS))
def test_bn_bwd_partials_unaligned_tensors_load_by_element(op):
    """x off a 16-byte boundary: both load by element; only g off it:
    bn_bwd_partials, which reads g, loads by element, bn_moments does not."""
    shape = (3, 100, 32, 1024)
    lay = _reduce(shape, 2, op, aligned=(False, True))
    assert lay["vec"] == 1 and lay["columns"] == 0
    lay = _reduce(shape, 2, op, aligned=(True, False))
    assert lay["vec"] == (8 if op == "moments" else 1)


# bce_rowsum_fwd (ops/elbo.py:bce_launch; csrc/bce_rowsum.cu): (N, K,
# logits' and targets' dtypes). The CelebA steps' image rows (eval: f32
# logits; train: bf16) and attribute rows, then K off the chunk and off
# the row split, K = 1, N = 1, rows of 33 chunks (just wide), 32 (just
# narrow) and 1000, rows long enough for a cluster (of 8 at most), an odd
# K over a cluster, narrow rows of 9 chunks; then the MNIST families' 784
# pixels: MNIST's step (f32 logits and targets), FashionMNIST's train step
# (bf16 both) and eval step (f32 logits, bf16 targets), and the IWAE's
# K * B = 100 * 100 sample rows
BCE_SHAPES = [(300, 12288, "f32", "bf16"), (300, 12288, "bf16", "bf16"),
              (300, 12288, "f32", "f32"), (300, 18, "f32", "f32"),
              (8, 12290, "bf16", "f32"), (300, 12296, "f32", "bf16"),
              (7, 1, "f32", "f32"), (1, 12288, "bf16", "bf16"),
              (5, 132, "f32", "f32"), (9, 128, "f32", "f32"),
              (3, 1000, "bf16", "f32"), (2, 1 << 18, "f32", "f32"),
              (4, 24576, "bf16", "bf16"), (6, 8193, "f32", "bf16"),
              (300, 36, "f32", "f32")]
BCE_784 = [(300, 784, "f32", "f32"), (300, 784, "bf16", "bf16"),
           (300, 784, "f32", "bf16"), (10000, 784, "f32", "f32")]
BCE_SHAPES += BCE_784
# MultiMNIST's 2500 pixels: the bf16 train step (bf16 both: 2500 holds no
# whole 16-byte chunk of bf16), the eval step (f32 logits, bf16 targets)
# and the IWAE's sample rows (f32); celeba19's train step, T * B = 2100
# rows against 100 targets, and its joint eval
BCE_FAMILIES = [(300, 2500, "bf16", "bf16"), (300, 2500, "f32", "bf16"),
                (10000, 2500, "f32", "f32"), (2100, 12288, "bf16", "bf16"),
                (100, 12288, "f32", "bf16")]
BCE_SHAPES += BCE_FAMILIES
# vision: the bf16 train step's T * B = 350 rows against 50 targets, the
# three-channel modalities' 12288 and the one-channel ones' 4096 (and
# 4096 under --f32), the joint eval's 50 rows (f32 logits, bf16 targets),
# the IWAE's 50 * 100 sample rows of one chunk (f32)
BCE_VISION = [(350, 12288, "bf16", "bf16"), (350, 4096, "bf16", "bf16"),
              (350, 4096, "f32", "f32"), (50, 4096, "f32", "bf16"),
              (50, 12288, "f32", "bf16"), (5000, 4096, "f32", "f32"),
              (5000, 12288, "f32", "f32")]
BCE_SHAPES += BCE_VISION
_SIZE = {"f32": 4, "bf16": 2}


def _bce(shape, aligned=True):
    n, k, xdt, tdt = shape
    return elbo.bce_launch(n, k, _SIZE[xdt], _SIZE[tdt], aligned)


def _bce_chunks_of_threads(lay, n, k):
    """(row, chunk) of every load the kernel makes, in its order: block
    (bx, y), thread i: row bx * (threads / lanes) + i / lanes, chunks
    y * span + i % lanes, + lanes * unroll, ... (each trip's `unroll`
    chunks lanes apart) below min(chunks, (y + 1) * span)."""
    chunks = k // lay["vec"]
    rows, found = [], []
    per_block = lay["threads"] // lay["lanes"]
    i = np.arange(lay["threads"])
    for bx in range(lay["grid"][0]):
        row = bx * per_block + i // lay["lanes"]
        for y in range(lay["grid"][1]):
            c1 = min(chunks, (y + 1) * lay["span"])
            c = y * lay["span"] + i % lay["lanes"]
            while (c < c1).any():
                for u in range(lay["unroll"]):
                    j = c + u * lay["lanes"]
                    live = (j < c1) & (row < n)
                    rows.append(row[live])
                    found.append(j[live])
                c = c + lay["lanes"] * lay["unroll"]
    return np.concatenate(rows), np.concatenate(found)


@pytest.mark.parametrize("shape", BCE_SHAPES)
def test_bce_chunks_in_exactly_one_block(shape):
    """Every chunk of every row is loaded by exactly one thread of the
    grid, and the chunks cover the row; no block is empty along a row;
    the clusters hold at most 8 blocks; the block fits the kernel."""
    n, k = shape[:2]
    lay = _bce(shape)
    vec, chunks = lay["vec"], k // lay["vec"]
    assert chunks * vec == k
    rows, found = _bce_chunks_of_threads(lay, n, k)
    cover = np.bincount(rows * chunks + found, minlength=n * chunks)
    assert len(cover) == n * chunks and (cover == 1).all()
    assert 1 <= lay["splits"] <= elbo.MAX_CLUSTER
    assert (lay["splits"] - 1) * lay["span"] < chunks <= (
        lay["splits"] * lay["span"])
    assert lay["grid"][1] == lay["splits"]
    t, lanes = lay["threads"], lay["lanes"]
    assert 32 <= t <= elbo.BCE_THREADS and t % 32 == 0
    assert lanes & (lanes - 1) == 0 and t % lanes == 0
    assert lanes == t or (lanes <= 32 and lay["splits"] == 1)


@pytest.mark.parametrize("shape", BCE_SHAPES[:3])
def test_bce_fills_the_card_at_celeba_shapes(shape):
    """The steps' (300, 12288) image rows, f32 or bf16 logits, f32 or bf16
    targets: each row in one plain block of BCE_THREADS (a cluster of 2
    read slower on the card, PERF.md), 16-byte chunks, at most BCE_CHUNKS
    chunks a thread, at least two blocks an SM."""
    lay = _bce(shape)
    assert lay["splits"] == 1
    assert lay["grid"][0] * lay["grid"][1] >= 2 * SM_COUNT
    assert lay["lanes"] == lay["threads"] == elbo.BCE_THREADS
    assert lay["vec"] == 16 // min(_SIZE[shape[2]], _SIZE[shape[3]])
    assert -(-lay["span"] // lay["threads"]) <= elbo.BCE_CHUNKS


def test_bce_attribute_rows_take_the_narrow_mapping():
    """K = 18 (f32, not a whole number of 16-byte chunks): a warp a row,
    a block of BCE_THREADS holds BCE_THREADS / 32 rows, one block along
    the row."""
    lay = _bce((300, 18, "f32", "f32"))
    assert lay["vec"] == 1 and lay["lanes"] == 32 and lay["splits"] == 1
    per_block = elbo.BCE_THREADS // 32
    assert lay["threads"] // lay["lanes"] == per_block > 1
    assert lay["grid"] == (-(-300 // per_block), 1)


@pytest.mark.parametrize("shape", BCE_784)
def test_bce_784_rows_take_one_plain_block_a_row(shape):
    """A 784-pixel row: one plain block a row (no cluster), 16-byte chunks
    of the narrower type, and threads enough that each loads its chunks
    in one trip of BCE_UNROLL."""
    lay = _bce(shape)
    vec = 16 // min(_SIZE[shape[2]], _SIZE[shape[3]])
    assert lay["vec"] == vec and lay["splits"] == 1
    assert lay["grid"] == (shape[0], 1)
    assert lay["lanes"] == lay["threads"] < elbo.BCE_THREADS
    assert 784 // vec <= lay["threads"] * elbo.BCE_UNROLL < 2 * 784 // vec


@pytest.mark.parametrize("n,nt", [(10000, 100), (300, 100), (12, 4),
                                  (350, 50), (5000, 50)])
def test_bce_shared_target_rows_are_read_by_each_group(n, nt):
    """Logit row r reads target row r mod Nt (csrc/bce_rowsum.cu:83): over
    the geometry's loads, every chunk of every target row is read once by
    each of the N / Nt groups of rows (the IWAE's K samples, the ELBO's T
    terms), and a row's loads read one target row."""
    lay = elbo.bce_launch(n, 784, 4, 4, True)
    chunks = 784 // lay["vec"]
    rows, found = _bce_chunks_of_threads(lay, n, 784)
    target = rows % nt
    cover = np.bincount(target * chunks + found, minlength=nt * chunks)
    assert (cover == n // nt).all()
    assert (np.bincount(rows, minlength=n) == chunks).all()


@pytest.mark.parametrize("shape", BCE_VISION)
def test_bce_vision_rows_take_one_plain_block_a_row(shape):
    """Vision's rows, 12288 and 4096 wide: 16-byte chunks of the narrower
    type, one plain block of BCE_THREADS a row (no cluster), at most
    BCE_CHUNKS chunks a thread."""
    lay = _bce(shape)
    assert lay["vec"] == 16 // min(_SIZE[shape[2]], _SIZE[shape[3]])
    assert lay["splits"] == 1 and lay["grid"] == (shape[0], 1)
    assert lay["lanes"] == lay["threads"] == elbo.BCE_THREADS
    assert -(-lay["span"] // lay["threads"]) <= elbo.BCE_CHUNKS


@pytest.mark.parametrize("shape,aligned", [
    ((300, 12288, "f32", "bf16"), False), ((8, 12290, "bf16", "f32"), True),
    ((300, 12294, "f32", "f32"), True), ((300, 18, "f32", "f32"), True),
    ((300, 2500, "bf16", "bf16"), True), ((300, 2500, "f32", "bf16"), True)])
def test_bce_unaligned_or_ragged_rows_load_by_element(shape, aligned):
    """A tensor off a 16-byte boundary, or K not a whole number of 16-byte
    chunks of the narrower type, loads element by element."""
    lay = _bce(shape, aligned=aligned)
    assert lay["vec"] == 1


# bn_normalize and bn_dx: one flat stream over the (G, N, C, S) view
# (ops/bn.py:normalize_launch, dx_launch; csrc/bn_swish.cu:stream). The
# CelebA layers, then S = 1 with C off the chunk and an odd numel, S = 25,
# S = 3 and 5 with odd numels, (G, C) = (2, 4000)
STREAM_SHAPES = BN_CELEBA + [(1, 5, 7, 1), (2, 3, 4, 25), (1, 3, 5, 3),
                             (3, 7, 9, 5), (1, 33, 50, 1),
                             (2, 20, 4000, 1)] + BN_MULTIMNIST + BN_VISION
# each tensor's address modulo 16: aligned; x and the output both 2 or 4
# bytes past a boundary (a head); x off by one element against the rest
# (no 16-byte chunk lines up in all, one element a chunk)
STREAM_OFFSETS = ["aligned", "offset", "mismatched"]
STREAM_KINDS = {"normalize": (bn_ops.normalize_launch, 2),
                "dx": (bn_ops.dx_launch, 3)}


def _stream(shape, dtype, kind, offsets):
    itemsize = torch.empty((), dtype=dtype).element_size()
    launch, n_tensors = STREAM_KINDS[kind]
    off = {"aligned": (0,) * n_tensors,
           "offset": (itemsize,) * n_tensors,
           "mismatched": (itemsize,) + (0,) * (n_tensors - 1)}[offsets]
    return launch(*shape, itemsize, off), itemsize, off


def _chunks_of_threads(lay):
    """The chunk indices each grid thread takes, in the kernel's order:
    k = t, then k += unroll * stride while k < chunks, chunks k + u *
    stride (u < unroll) below chunks. Returns (thread, chunk) arrays."""
    stride = lay["blocks"] * lay["threads"]
    t = np.arange(stride, dtype=np.int64)
    ts, js = [], []
    k = t.copy()
    while (k < lay["chunks"]).any():
        for u in range(lay["unroll"]):
            j = k + u * stride
            live = j < lay["chunks"]
            ts.append(t[live])
            js.append(j[live])
        k = k + lay["unroll"] * stride
    if not ts:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    return np.concatenate(ts), np.concatenate(js)


def _channel_of(lay, c, e):
    """The kernel's (g, c) of elements e (csrc/bn_swish.cu:channel_of):
    three FastDiv divisions, each a 32x32 multiply-high and a shift."""
    ms, ss, mc, sc, mg, sg = (np.uint64(v) for v in lay["divs"])

    def div(n, m, s):
        if m == 0:
            return n
        return ((n * m) >> np.uint64(32)) >> s

    e = e.astype(np.uint64)
    run = div(e, ms, ss)
    ch = run - div(run, mc, sc) * np.uint64(c)
    return (div(e, mg, sg) * np.uint64(c) + ch).astype(np.int64)


@pytest.mark.parametrize("offsets", STREAM_OFFSETS)
@pytest.mark.parametrize("kind", sorted(STREAM_KINDS))
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", STREAM_SHAPES)
def test_bn_stream_reads_and_writes_every_element_once(shape, dtype, kind,
                                                       offsets):
    """Every element is taken by exactly one thread of the grid: in a
    16-byte chunk aligned in every tensor, or as the head or the tail; the
    edges fit the first threads; the grid is a whole wave of resident
    blocks on SM_COUNT SMs."""
    lay, itemsize, off = _stream(shape, dtype, kind, offsets)
    g, n, c, s = shape
    numel = g * n * c * s
    vec = lay["vec"]
    assert vec == (1 if offsets == "mismatched" else 16 // itemsize)
    assert lay["head"] == (0 if vec == 1 else min(numel, (16 - off[0]) % 16
                                                  // itemsize))
    if vec == 1:
        assert lay["head"] == lay["tail"] == 0
    else:
        assert 0 <= lay["head"] < vec and 0 <= lay["tail"] < vec
    for o in off:
        assert (o + lay["head"] * itemsize) % 16 == 0 or vec == 1
    _, chunk = _chunks_of_threads(lay)
    elems = (lay["head"] + chunk[:, None] * vec
             + np.arange(vec)[None, :]).ravel()
    edge_t = np.arange(lay["head"] + lay["tail"])
    assert len(edge_t) <= lay["threads"]
    edges = np.where(edge_t < lay["head"], edge_t,
                     lay["head"] + lay["chunks"] * vec
                     + (edge_t - lay["head"]))
    cover = np.bincount(np.concatenate([elems, edges]), minlength=numel)
    assert len(cover) == numel and (cover == 1).all()
    assert lay["threads"] == bn_ops.STREAM_THREADS
    assert lay["blocks"] % SM_COUNT == 0
    assert 1 <= lay["blocks"] // SM_COUNT <= bn_ops.STREAM_BLOCKS_PER_SM
    if lay["blocks"] > SM_COUNT:        # no block of a second wave idles
        assert lay["chunks"] > (lay["blocks"] - SM_COUNT) * lay["threads"]
    assert set(lay) == {"vec", "head", "chunks", "tail", "whole", "unroll",
                        "threads", "blocks", "lanes", "divs"}


@pytest.mark.parametrize("offsets", STREAM_OFFSETS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", STREAM_SHAPES)
def test_bn_stream_gives_each_element_its_channel(shape, dtype, offsets):
    """The (g, c) the kernel forms for each element from its index by
    multiply-high and shift is the element's own; where the geometry says
    `whole`, every element of a chunk lies in the chunk's first element's
    channel, which is the one the kernel forms for all of them."""
    lay, *_ = _stream(shape, dtype, "normalize", offsets)
    g, n, c, s = shape
    numel = g * n * c * s
    step = 1 << 20
    for lo in range(0, numel, step):
        e = np.arange(lo, min(numel, lo + step), dtype=np.int64)
        want = e // (n * c * s) * c + e // s % c
        np.testing.assert_array_equal(_channel_of(lay, c, e), want)
    if lay["whole"]:
        assert s % lay["vec"] == 0 and lay["head"] == 0
        first = np.arange(lay["chunks"], dtype=np.int64) * lay["vec"]
        for i in range(1, lay["vec"]):
            np.testing.assert_array_equal(
                (first + i) // s % c, first // s % c)


@pytest.mark.parametrize("d", [1, 2, 3, 5, 7, 25, 64, 100, 256, 512, 1000,
                               4095, 4097, 25600, 102400, 3276800,
                               (1 << 30) + 1, (1 << 31) - 1])
def test_fast_div_is_exact_below_2_31(d):
    """n // d by multiply-high and shift for dividends the kernel forms
    (below 2^31): near 0, near every multiple of d up to 2^31 (sampled),
    and at random."""
    m, s = bn_ops.fast_div(d)
    rng = np.random.default_rng(d)
    top = (1 << 31) - 1
    mult = rng.integers(0, top // d + 1, 20000, dtype=np.int64) * d
    n = np.concatenate([np.arange(0, 4096), rng.integers(0, top, 20000),
                        mult, mult - 1, mult + d - 1,
                        [top, top - 1, top - d]])
    n = n[(n >= 0) & (n <= top)].astype(np.uint64)
    got = n if m == 0 else (n * np.uint64(m)) >> np.uint64(32 + s)
    np.testing.assert_array_equal(got, n // np.uint64(d))
    assert m < (1 << 32)


@pytest.mark.parametrize("dtype", DTYPES)
def test_bn_stream_whole_chunks_only_where_s_holds_them(dtype):
    """A chunk takes one channel for all its elements (`whole`) where S is
    a multiple of the chunk and x starts on a 16-byte boundary: the
    decoder's last BN and (3, 100, 128, 64); not at S = 25 or S = 1 (each
    element forms its own coefficients), nor with a head."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    assert bn_ops.normalize_launch(3, 100, 32, 1024, itemsize)["whole"]
    assert bn_ops.dx_launch(3, 100, 128, 64, itemsize)["whole"]
    assert not bn_ops.dx_launch(1, 100, 256, 25, itemsize)["whole"]
    assert not bn_ops.dx_launch(3, 100, 512, 1, itemsize)["whole"]
    assert not bn_ops.normalize_launch(3, 100, 32, 1024, itemsize,
                                       (itemsize, itemsize))["whole"]


@pytest.mark.parametrize("dtype", DTYPES)
def test_bn_stream_element_loads_at_multimnist_planes(dtype):
    """MultiMNIST's planes: S = 625 holds no whole chunk in either dtype,
    S = 36 and 4 only a whole f32 chunk (4 elements), S = 144 both: the
    streams take `whole` chunks only there, and every other element forms
    its own channel (the element-load path PERF.md times)."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    vec = 16 // itemsize
    for shape in BN_MULTIMNIST:
        for launch in (bn_ops.normalize_launch, bn_ops.dx_launch):
            lay = launch(*shape, itemsize)
            assert lay["whole"] == (shape[3] % vec == 0), shape


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", BN_CELEBA19)
def test_bn_stream_at_21_term_groups(shape, dtype):
    """celeba19's decoder planes at G = 21 (up to 68.8M elements): the
    streams' chunks cover the elements (head + chunks * vec + tail), whole
    chunks, a whole wave of blocks, and the (g, c) the kernel forms for a
    sample of 2^20 elements across the range (every group boundary and
    random ones) is each element's own."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    g, n, c, s = shape
    numel = g * n * c * s
    for kind in sorted(STREAM_KINDS):
        lay, *_ = _stream(shape, dtype, kind, "aligned")
        assert lay["head"] + lay["chunks"] * lay["vec"] + lay["tail"] == numel
        assert lay["whole"] and lay["vec"] == 16 // itemsize
        assert lay["blocks"] % SM_COUNT == 0
        assert lay["chunks"] > (lay["blocks"] - SM_COUNT) * lay["threads"]
    rng = np.random.default_rng(g + c)
    bounds = np.arange(g)[:, None] * (n * c * s) + np.array([-1, 0, 1])
    e = np.concatenate([bounds.ravel()[1:], numel - 1 - np.arange(4),
                        rng.integers(0, numel, 1 << 20)]).astype(np.int64)
    np.testing.assert_array_equal(_channel_of(lay, c, e),
                                  e // (n * c * s) * c + e // s % c)


# poe_fwd and poe_bwd (csrc/poe.cu): one column a thread in blocks of the
# kernels' constant kThreads, as many blocks as cover the columns; B*D
# columns of one row and of a few, MultiMNIST's 6400 (B = 100, D = 64),
# the CelebA and celeba19 steps' 10^4 (celeba19 at T = 21 and T = 1 with
# M = 19, the expert cap 32), one past it, and vision's 12500 (B = 50,
# D = 250; M = 6, the expert cap 8)
POE_COLS = [1, 7, 6400, 10000, 10003, 12500]
POE_SOURCE = Path(poe.__file__).parents[1] / "csrc" / "poe.cu"


def _poe_grid(n_cols):
    """(blocks, threads, columns): the grid csrc/poe.cu launches on n_cols
    columns (blocks_of), at its kThreads, and the column every thread of
    it reads (each row of mu, logvar and the upstream gradients) and
    writes (each row of the outputs), in the kernels' order: thread u =
    block * kThreads + lane takes column u if u < n_cols, else returns."""
    threads = int(re.search(r"constexpr int kThreads = (\d+);",
                            POE_SOURCE.read_text()).group(1))
    blocks = -(-n_cols // threads)
    u = np.arange(blocks * threads, dtype=np.int64)
    return blocks, threads, u[u < n_cols]


@pytest.mark.parametrize("n_cols", POE_COLS)
def test_poe_reads_and_writes_every_column_once(n_cols):
    """Every column is read and written by exactly one thread, none past
    the row, the ragged tail in the same launch; no block is empty; the
    block is one the card takes, in whole warps."""
    blocks, threads, cols = _poe_grid(n_cols)
    assert cols.max() < n_cols
    assert (np.bincount(cols, minlength=n_cols) == 1).all()
    assert (blocks - 1) * threads < n_cols
    assert 32 <= threads <= 1024 and threads % 32 == 0


@pytest.mark.parametrize("m,cap", [(1, 2), (2, 2), (3, 8), (6, 8), (8, 8),
                                   (9, 32), (19, 32), (32, 32)])
def test_poe_expert_cap_is_the_least_that_holds_the_experts(m, cap):
    """The kernels hold cap experts a column in registers: 2 at the main
    path's M = 2, 8 at vision's 6, 32 at celeba19's 19."""
    assert poe.expert_cap(m) == cap
    assert cap in poe.EXPERT_CAPS and poe.MAX_EXPERTS == max(poe.EXPERT_CAPS)


def test_poe_main_case_is_one_wave():
    """The steps' 10^4 columns: every thread of the grid resident on the
    card at once (2048 a SM), and more blocks than half the SMs."""
    blocks, threads, _ = _poe_grid(10000)
    assert blocks > SM_COUNT // 2
    assert blocks * threads <= SM_COUNT * 2048


def test_poe_vision_case_is_one_wave():
    """Vision's step, B * D = 50 * 250 columns at the expert cap 8: every
    thread of the grid resident on the card at once (2048 a SM), and
    more blocks than half the SMs."""
    blocks, threads, _ = _poe_grid(50 * 250)
    assert blocks > SM_COUNT // 2
    assert blocks * threads <= SM_COUNT * 2048
