"""The conv stacks' layout rule and the BN op's channels-last view, on the
CPU (the kernels' lanes forms run on the card: tests/test_torch_port_cuda.py).

A stack whose compute dtype is bf16 or fp16 keeps its activations
channels-last (nn/conv.py:activation_format); f32 stacks and the encoder's
fused route run NCHW. On the kernels the BN op views a channels-last map as
(G, N*H*W, C, 1); the plain versions, which the CPU runs, take its NCHW
copy; either way y and dx come back channels-last (ops/bn.py:
bn_swish_train). The
launch geometry of the lanes forms (ops/bn.py:reduce_launch,
normalize_launch, dx_launch) is repeated here in numpy, as
tests/test_torch_port_launch.py repeats the other forms'.
"""

import copy

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from mvae_tpu_torch.core import subsets
from mvae_tpu_torch.core.engine import multi_term_elbo
from mvae_tpu_torch.models.celeba import CelebaMVAE
from mvae_tpu_torch.models.celeba19 import Celeba19MVAE
from mvae_tpu_torch.nn import dcgan
from mvae_tpu_torch.nn.norm import BatchNorm
from mvae_tpu_torch.ops import bn as bn_ops
from mvae_tpu_torch.ops._cuda import MAX_CLUSTER, SM_COUNT
from mvae_tpu_torch.tools import measure
from mvae_tpu_torch.tools.measure import family_of
from mvae_tpu_torch.train.loop import draw_noise, make_train_step

aten = torch.ops.aten
L = 8
MASKS = [[1.0, 1.0], [1.0, 0.0], [0.0, 1.0]]
LAMBDAS = [[1.0, 10.0]] * 3


@pytest.fixture(autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _uint8_batch(b, seed):
    rng = np.random.default_rng(seed)
    return {"image": torch.from_numpy(
                rng.integers(0, 256, (b, 64, 64, 3), dtype=np.uint8)),
            "attrs": torch.from_numpy(
                (rng.random((b, 18)) < 0.3).astype(np.float32))}


class ConvLayouts(TorchDispatchMode):
    """Each aten convolution and convolution backward: whether its
    activation (the input of the forward, the saved input of the backward)
    is channels-last, whether it is transposed, and its weight's shape."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is aten.convolution.default:
            self.calls.append((bn_ops.is_channels_last(args[0]),
                               bool(args[6]), tuple(args[1].shape)))
        elif func is aten.convolution_backward.default:
            self.calls.append((bn_ops.is_channels_last(args[1]),
                               bool(args[7]), tuple(args[2].shape)))
        return func(*args, **(kwargs or {}))

    def share(self, keep=lambda transposed, weight: True):
        """The share of the counted calls whose activation is
        channels-last."""
        hits = [cl for cl, tr, w in self.calls if keep(tr, w)]
        assert hits
        return sum(hits) / len(hits)


class GradLayouts(TorchDispatchMode):
    """Of each aten convolution backward, whether the gradient of its
    output is channels-last."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is aten.convolution_backward.default:
            self.calls.append(bn_ops.is_channels_last(args[0]))
        return func(*args, **(kwargs or {}))


def _celeba_step(dtype, conv_moments=False):
    model = CelebaMVAE(L, dtype, conv_moments=conv_moments, device="cpu")
    step = make_train_step(model, MASKS, LAMBDAS, lr=1e-4, device="cpu",
                           generator=torch.Generator().manual_seed(0))
    return model, lambda: step(_uint8_batch(4, 1), 1.0)


def _celeba19_step(dtype):
    model = Celeba19MVAE(L, dtype, bf16_loss=dtype is not None,
                         device="cpu")
    masks, lambdas = subsets.celeba19_step_terms(
        np.random.default_rng(0), 1, 18, 1.0, 1.0)
    step = make_train_step(model, masks, lambdas, lr=1e-4, device="cpu",
                           generator=torch.Generator().manual_seed(0),
                           recon_support=subsets.celeba19_recon_support(1))
    return model, lambda: step(_uint8_batch(2, 2), 1.0)


def _vision_step(dtype, stack=False):
    from mvae_tpu_torch.models.vision import CHANNELS, MODALITIES, VisionMVAE
    model = VisionMVAE(L, dtype, stack_modalities=stack, device="cpu")
    masks = np.concatenate([np.ones((1, 6), np.float32),
                            np.eye(6, dtype=np.float32)])
    step = make_train_step(model, masks, np.full((7, 6), 1.0 / 6.0,
                                                 np.float32),
                           lr=1e-4, device="cpu",
                           generator=torch.Generator().manual_seed(0),
                           recon_masks=np.ones((7, 6), np.float32))
    rng = np.random.default_rng(6)
    batch = {m: torch.from_numpy(rng.integers(
                 0, 256, (2, 64, 64, CHANNELS[m]), dtype=np.uint8))
             for m in MODALITIES}
    return model, lambda: step(batch, 1.0)


# family -> (its train step, whether its convs are grouped: vision's
# stacked form, whose convs run NCHW in every dtype, nn/conv.py)
STEPS = {"celeba": (_celeba_step, False), "celeba19": (_celeba19_step, False),
         "vision": (_vision_step, False),
         "vision_stacked": (lambda dtype: _vision_step(dtype, True), True)}


@pytest.mark.parametrize("family", sorted(STEPS))
@pytest.mark.parametrize("dtype", [torch.bfloat16, None])
def test_train_step_convs_take_the_layout_of_their_dtype(family, dtype):
    """The layout's engagement counter: of one train step's convolutions
    and convolution backwards, the share whose activation is channels-last
    is 100% in bf16 and 0% in f32, and 0% for grouped convs."""
    make, grouped = STEPS[family]
    _, step = make(dtype)
    with ConvLayouts() as seen:
        step()
    assert len(seen.calls) >= 16
    assert seen.share() == float(dtype is not None and not grouped)


def test_fused_encoder_route_stays_nchw():
    """Under conv_moments=True (bf16) the encoder's BN'd convs run NCHW,
    forward and backward, as conv2d_moments reads NCHW; the decoder's
    transposed convolutions stay channels-last."""
    model, step = _celeba_step(torch.bfloat16, conv_moments=True)
    bn_convs = {tuple(m.weight.shape) for m in (
        model.image_encoder.features[i] for i in (2, 5, 8))}
    assert len(bn_convs) == 3
    with ConvLayouts() as seen:
        step()
    assert seen.share(lambda tr, w: not tr and w in bn_convs) == 0.0
    assert seen.share(lambda tr, w: tr) == 1.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("groups", [1, 2, 18])
def test_bn_op_on_a_channels_last_map_equals_the_nchw_call(groups, dtype):
    """bn_swish_train on a channels-last x equals the NCHW call on the same
    values: y, mean and var, and the gradients of x, scale and bias, bit
    for bit, since the plain versions sum the map's NCHW copy (the card's
    lanes forms, which sum in another order, are held to the plain
    versions in tests/test_torch_port_cuda.py). y and dx come back
    channels-last."""
    g = torch.Generator().manual_seed(groups)
    n, c, h, w = 3 * groups, 16, 4, 5
    x = (0.5 + 1.5 * torch.randn((n, c, h, w), generator=g)).to(dtype)
    ct = torch.randn((n, c, h, w), generator=g).to(dtype)
    outs = []
    for fmt in (torch.contiguous_format, torch.channels_last):
        xi = x.clone(memory_format=fmt).requires_grad_(True)
        scale = (1.0 + 0.2 * torch.randn(c, generator=torch.Generator()
                                         .manual_seed(7))).requires_grad_()
        bias = torch.zeros(c, requires_grad=True)
        y, mean, var = bn_ops.bn_swish_train(xi, scale, bias, groups)
        y.backward(ct.contiguous(memory_format=fmt))
        assert y.shape == x.shape and y.dtype == dtype
        assert y.is_contiguous(memory_format=fmt)
        assert xi.grad.is_contiguous(memory_format=fmt)
        outs.append((y, mean, var, xi.grad, scale.grad, bias.grad))
    assert not outs[1][0].is_contiguous()
    for got, want in zip(outs[1], outs[0]):
        assert torch.equal(got, want)


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("groups,c_in,c_out", [(1, 3, 32), (1, 32, 3),
                                               (3, 3, 32), (3, 32, 3),
                                               (1, 1, 32), (1, 32, 1),
                                               (2, 5, 12), (1, 16, 32)])
def test_channels_last_conv_pads_channels_to_whole_runs(groups, c_in, c_out,
                                                        transposed):
    """A bf16 channels-last conv or transposed conv whose channels hold no
    whole 16-byte run (the images' 3 and 1) runs on channels padded with
    zeros to CHANNEL_RUN and drops the padded outputs: y and the gradients
    of x and the weight equal the unpadded conv's in f32 on the same bf16
    values, to one bf16 rounding of y and to the order of the sums; y
    carries c_out channels a group, channels-last where the conv is
    ungrouped, and its backward gets a channels-last gradient (no
    transpose). A grouped conv runs NCHW (nn/conv.py), y NCHW too."""
    from mvae_tpu_torch.nn import conv as conv_mod
    g = torch.Generator().manual_seed(c_in * 7 + c_out)
    x = torch.randn((2, groups * c_in, 12, 12), generator=g).bfloat16()
    wshape = ((groups * c_in, c_out, 4, 4) if transposed
              else (groups * c_out, c_in, 4, 4))
    w = torch.randn(wshape, generator=g)
    fn = conv_mod.conv_transpose2d if transposed else conv_mod.conv2d
    ref_fn = F.conv_transpose2d if transposed else F.conv2d
    xi = x.clone(memory_format=torch.channels_last).requires_grad_(True)
    wi = w.clone().requires_grad_(True)
    y = fn(xi, wi, stride=2, padding=1, groups=groups)
    xr = x.float().requires_grad_(True)
    wr = w.bfloat16().float().requires_grad_(True)
    ref = ref_fn(xr, wr, stride=2, padding=1, groups=groups)
    fmt = torch.channels_last if groups == 1 else torch.contiguous_format
    assert y.shape == ref.shape and y.dtype == torch.bfloat16
    assert y.is_contiguous(memory_format=fmt)
    torch.testing.assert_close(y.float(), ref, rtol=2 ** -7, atol=1e-2)
    ct = torch.randn(ref.shape, generator=g).bfloat16()
    with GradLayouts() as grads:
        y.backward(ct.contiguous(memory_format=fmt))
    ref.backward(ct.float())
    assert grads.calls == [fmt == torch.channels_last]
    assert xi.grad.is_contiguous(memory_format=torch.channels_last)
    for got, want in ((xi.grad, xr.grad), (wi.grad, wr.grad)):
        gap = (got.float() - want).norm() / want.norm()
        assert gap < 2e-2, gap


def _elbo_and_grads(model, batch, noise):
    model.train()
    model.zero_grad(set_to_none=True)
    total, _ = multi_term_elbo(model, batch, torch.tensor(MASKS),
                               torch.tensor(LAMBDAS), 1.0, train=True,
                               noise=noise)
    total.backward()
    return total.detach(), {k: p.grad.clone()
                            for k, p in model.named_parameters()}


def test_bf16_step_channels_last_equals_nchw(monkeypatch):
    """A bf16 train-mode ELBO and its gradients at the channels-last layout
    against the same step with the stacks held NCHW: the loss within 1e-3
    and every gradient within 5% in relative norm (bf16 convolutions sum in
    another order in each layout), but for the Linear biases that feed a
    BN, whose gradient is exactly 0 and rounding noise on both sides
    (within 1e-4). The model's state_dict keeps its keys, shapes and OIHW
    layouts, and loads strictly into a fresh model."""
    model = CelebaMVAE(L, torch.bfloat16, device="cpu")
    twin = copy.deepcopy(model)
    batch = {k: v.float() / (255.0 if k == "image" else 1.0)
             for k, v in _uint8_batch(4, 3).items()}
    noise = draw_noise(model, 3, 4, torch.Generator().manual_seed(5))
    total, grads = _elbo_and_grads(model, batch, noise)
    monkeypatch.setattr(dcgan, "activation_format",
                        lambda dtype: torch.contiguous_format)
    with ConvLayouts() as seen:
        n_total, n_grads = _elbo_and_grads(twin, batch, noise)
    assert seen.share() == 0.0
    torch.testing.assert_close(total, n_total, rtol=1e-3, atol=0)
    noisy = {f"{name}.{i}.bias" for name, mod in model.named_modules()
             if isinstance(mod, torch.nn.Sequential)
             for i in range(len(mod) - 1)
             if isinstance(mod[i + 1], BatchNorm)
             and getattr(mod[i], "bias", None) is not None}
    assert len(noisy) == 5
    for k, want in n_grads.items():
        gap = (grads[k] - want).norm().item()
        bound = 1e-4 if k in noisy else 0.05 * want.norm().item()
        assert gap <= bound, (k, gap)
    state = model.state_dict()
    assert {k: v.shape for k, v in state.items()} == {
        k: v.shape for k, v in twin.state_dict().items()}
    for k, v in state.items():
        assert v.is_contiguous(), k
    fresh = CelebaMVAE(L, torch.bfloat16, device="cpu")
    fresh.load_state_dict(state, strict=True)


def _multimnist_step(dtype):
    from mvae_tpu_torch.models.multimnist import MultiMnistMVAE
    model = MultiMnistMVAE(L, dtype, device="cpu",
                           generator=torch.Generator().manual_seed(2))
    step = make_train_step(model, MASKS, LAMBDAS, lr=1e-4, device="cpu",
                           generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(7)
    batch = {"image": torch.from_numpy(rng.integers(
                 0, 256, (3, 50, 50, 1), dtype=np.uint8)),
             "text": torch.from_numpy(rng.integers(0, 12, (3, 4)))}
    return model, lambda: step(batch, 1.0)


@pytest.mark.parametrize("family", ["celeba", "celeba19", "multimnist"])
def test_bf16_step_flops_are_the_count_plus_the_channel_padding(family):
    """FlopCounterMode's count of a bf16 train step equals measure.
    count_step's flops_per_step, dead work and channel padding, plus the
    PoE plain version's products, which the card's kernel does not run
    (tests/test_torch_port_grouped_decode.py), as chip_smoke.py checks on
    the card. CelebA's padding is the closed form from shapes: 5 zero
    channels on the first conv (forward and weight gradient, B rows) and
    on the last convT (forward, input and weight gradients on the two
    terms with the image, the forward alone on the third), each 2 * 32 *
    16 weights * 32 * 32 pixels a row."""
    make = {"celeba": _celeba_step, "celeba19": _celeba19_step,
            "multimnist": _multimnist_step}[family]
    model, step = make(torch.bfloat16)
    step()
    with FlopCounterMode(display=False) as counter:
        step()
    if family == "celeba19":
        masks, lambdas = subsets.celeba19_step_terms(
            np.random.default_rng(0), 1, 18, 1.0, 1.0)
        support, b = subsets.celeba19_recon_support(1), 2
    else:
        masks, lambdas, support = MASKS, LAMBDAS, None
        b = 4 if family == "celeba" else 3
    want = measure.count_step(model, masks, lambdas, b,
                              recon_support=support)
    t, m = np.asarray(masks).shape
    poe = 6 * 2 * t * m * b * L
    assert want.padding > 0
    assert counter.get_total_flops() == (want.needed + want.dead
                                         + want.padding + poe)
    if family == "celeba":
        assert want.padding == b * (2 + 3 * 2 + 1) * 2 * 32 * 5 * 16 * 32 ** 2


# the cells' channels-last planes as the BN op views them, (G, N*H*W, C, 1):
# CelebA's decoder convT3 at B = 4096, the live terms' call and the dead
# one's, its convT2 and convT1, its encoder's conv2-conv4; celeba19's dead
# terms at B = 2048
CELL_PLANES = [(2, 4096 * 1024, 32, 1), (1, 4096 * 1024, 32, 1),
               (2, 4096 * 256, 64, 1), (2, 4096 * 64, 128, 1),
               (1, 4096 * 256, 64, 1), (1, 4096 * 64, 128, 1),
               (1, 4096 * 25, 256, 1), (18, 2048 * 1024, 32, 1)]
# small row counts (BatchNorm1d at the paper's B = 100, a channels-last map
# of few rows) keep the columns mapping
SMALL_PLANES = [(1, 100, 512, 1), (3, 100, 512, 1), (1, 1000, 64, 1),
                (2, bn_ops.LANES_MIN_ROWS - 1, 32, 1)]


def _reduce(shape, itemsize, inputs=1):
    return bn_ops.reduce_launch(*shape, itemsize, True, inputs)


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("shape", CELL_PLANES)
def test_lanes_reduction_fills_the_card_at_the_cells_planes(shape,
                                                            itemsize):
    """At the cells' planes both reductions take the lanes mapping: a
    grid of at least SM_COUNT blocks, a group's blocks in whole clusters,
    whole 16-byte chunks a thread, every row of every group read by
    exactly one (block, row lane), as the kernel walks them."""
    g, n, c, _ = shape
    for inputs in (1, 2):
        lay = _reduce(shape, itemsize, inputs)
        assert lay["columns"] == 2 and lay["vec"] == 16 // itemsize
        assert lay["grid"] == (lay["splits"], g)
        assert lay["splits"] * g >= SM_COUNT
        assert lay["splits"] % min(lay["splits"], MAX_CLUSTER) == 0
        assert lay["tpr"] * lay["vec"] == c
        assert lay["rows"] == lay["threads"] // lay["tpr"]
    # rows n0 = b * lanes + lane, then every splits * lanes rows
    lanes, splits = lay["rows"], lay["splits"]
    starts = np.arange(splits)[:, None] * lanes + np.arange(lanes)[None, :]
    per = -(-n // (splits * lanes))
    rows = (starts.ravel()[:, None]
            + np.arange(per)[None, :] * splits * lanes).ravel()
    cover = np.bincount(rows[rows < n], minlength=n)
    assert len(cover) == n and (cover == 1).all()


@pytest.mark.parametrize("shape", SMALL_PLANES)
def test_small_row_counts_keep_the_columns_mapping(shape):
    """Below LANES_MIN_ROWS rows a group (or with x off a 16-byte
    boundary, or C not whole chunks) the reductions keep the columns
    mapping and its one cluster, as before the lanes mapping."""
    for itemsize in (2, 4):
        lay = _reduce(shape, itemsize)
        assert lay["columns"] == 1 and lay["splits"] <= MAX_CLUSTER
    big = (1, 4 * bn_ops.LANES_MIN_ROWS, 40, 1)
    assert bn_ops.reduce_launch(*big, 2, False, 1)["columns"] == 1
    assert bn_ops.reduce_launch(1, 1 << 16, 36, 1, 2, True, 1)[
        "columns"] == 1


@pytest.mark.parametrize("kind", ["normalize", "dx"])
@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("shape", CELL_PLANES + SMALL_PLANES)
def test_lanes_stream_keeps_each_thread_on_its_channels(shape, itemsize,
                                                        kind):
    """The lanes streams: the grid's stride in elements is a multiple of C,
    so that thread t's chunks j = t, t + stride, ... all hold channels
    (t % lanes) * vec onward; the group the kernel forms where a chunk
    enters one (j // (N * lanes)) is the chunk's own; one wave of whole
    blocks."""
    g, n, c, _ = shape
    launch = {"normalize": bn_ops.normalize_launch,
              "dx": bn_ops.dx_launch}[kind]
    lay = launch(*shape, itemsize)
    vec, lanes = lay["vec"], lay["lanes"]
    assert vec == 16 // itemsize and lanes == c // vec
    assert lay["head"] == lay["tail"] == 0 and not lay["whole"]
    stride = lay["blocks"] * lay["threads"]
    assert stride * vec % c == 0
    assert lay["blocks"] % SM_COUNT == 0
    cap = (bn_ops.STREAM_BLOCKS_PER_SM if kind == "normalize"
           else bn_ops.LANES_DX_BLOCKS_PER_SM)
    assert lay["blocks"] // SM_COUNT <= cap
    rng = np.random.default_rng(c)
    t = rng.integers(0, stride, 4096)
    j = t + rng.integers(0, -(-lay["chunks"] // stride), 4096) * stride
    t, j = t[j < lay["chunks"]], j[j < lay["chunks"]]
    elem = j * vec
    np.testing.assert_array_equal(elem % c, (t % lanes) * vec)
    np.testing.assert_array_equal(j // (n * lanes), elem // (n * c))


def test_streams_keep_the_flat_form_off_the_lanes_shapes():
    """A head (x off a 16-byte boundary), C not whole chunks, or a row of
    chunks that no grid stride holds (C = 4000 in f32: 1000 chunks) keep
    the flat stream (lanes 0)."""
    assert not bn_ops.normalize_launch(1, 1 << 14, 32, 1, 2, (2, 2))["lanes"]
    assert not bn_ops.normalize_launch(1, 1 << 14, 36, 1, 2)["lanes"]
    assert not bn_ops.dx_launch(2, 40, 4000, 1, 4)["lanes"]
    assert not bn_ops.dx_launch(3, 100, 32, 1024, 2)["lanes"]


@pytest.mark.parametrize("name", ["void cudnn::ops::nchwToNhwcKernel<"
                                  "__nv_bfloat16, __nv_bfloat16, float, "
                                  "false, true, (cudnnKernelDataType_t)0>",
                                  "void cudnn::ops::nhwcToNchwKernel<"
                                  "float, __nv_bfloat16, float, true, "
                                  "false, (cudnnKernelDataType_t)0>"])
def test_layout_transforms_are_their_own_family(name):
    """cuDNN's layout transforms are a family of their own, whichever aten
    op the profiler links them to (they run inside convolutions)."""
    fam = "layout transform (cuDNN)"
    assert family_of(name) == fam
    assert family_of(name, "aten::cudnn_convolution") == fam
    assert family_of("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_"
                     "nhwckrsc_nhwc", "aten::cudnn_convolution") != fam
