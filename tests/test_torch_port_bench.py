"""The port's measuring tools (mvae_tpu_torch/tools/bench.py,
bench_families.py, roofline_family.py, serve_latency.py over
tools/measure.py) against the JAX package's scripts: each family's
benchmarked step is scripts/bench_families.py's, the CelebA bench is
bench.py's but for its term weights, the FLOPs a step from shapes equal
FlopCounterMode's count of a port step (less the dead work, which the
count leaves out: the forwards of the BN'd decoders for the terms that
never train them) and stay under XLA's cost analysis of the JAX step; the
tools run on the card unless --device cpu, where every device metric is
null; the reference flow runs three forwards a step.

CPU only: the card runs them through chip_smoke.py's bench phase and
tests/test_torch_port_cuda.py.
"""

import importlib.util
import json
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from mvae_tpu.models.mnist import MnistMVAE as JaxMnistMVAE
from mvae_tpu.train.loop import make_multi_train_step as jax_multi_step
from mvae_tpu_torch.core.subsets import (
    celeba19_recon_support, celeba19_step_terms)
from mvae_tpu_torch.experiments.celeba import train as celeba_cli
from mvae_tpu_torch.experiments.vision import train as vision_cli
from mvae_tpu_torch.models import (
    Celeba19MVAE, CelebaMVAE, FashionMnistMVAE, MnistMVAE, MultiMnistMVAE,
    VisionMVAE)
from mvae_tpu_torch.tools import (
    bench, bench_families, measure, roofline_family, serve_latency)
from mvae_tpu_torch.train.loop import make_train_step

ROOT = Path(__file__).resolve().parents[1]
MASKS = [[1.0, 1.0], [1.0, 0.0], [0.0, 1.0]]
LAMBDAS = [[1.0, 10.0]] * 3
DEVICE_METRICS = ("idle_share", "mfu", "tflops_sustained",
                  "device_ms_per_step", "launches_per_step",
                  "peak_mem_bytes")


@pytest.fixture(autouse=True)
def one_thread():
    """Small CPU ops under the lane's six workers run far faster on one
    intra-op thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def load_script(path, name):
    spec = importlib.util.spec_from_file_location(name, ROOT / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_families():
    return load_script("scripts/bench_families.py", "jax_bench_families")


def dtype_name(dtype):
    """A torch or JAX dtype's name ("float32"), "none" for None."""
    if dtype is None:
        return "none"
    if isinstance(dtype, torch.dtype):
        return str(dtype).split(".")[-1]
    return np.dtype(dtype).name


@pytest.mark.parametrize("family", bench_families.FAMILY_NAMES)
def test_family_spec_is_the_jax_scripts(jax_families, family):
    """family_spec(name) at seed 0 is scripts/bench_families.py's
    FAMILIES[name] at np.random.default_rng(0): the model and its width
    and compute dtype (f32 and bf16), the data's keys, shapes, dtypes and
    values (the JAX rows carry a leading device axis of 1), the masks,
    lambdas, batch, recon masks and support, and the rows of a window
    drawn next from the same generator."""
    k = 3
    rng = np.random.default_rng(0)
    jmodel, jdata, jmasks, jlambdas, opts = jax_families.FAMILIES[family](
        rng, None)
    batch = opts.get("batch", 100)
    n = next(iter(jdata.values())).shape[1]
    jidxs = rng.integers(0, n, (k, 1, batch))[:, 0]
    spec = bench_families.family_spec(family, seed=0, k=k)
    assert spec.model_cls.__name__ == type(jmodel).__name__
    assert spec.width == jmodel.n_latents
    assert dtype_name(spec.compute_dtype) == dtype_name(jmodel.compute_dtype)
    bf16 = bench_families.family_spec(family, bf16=True, seed=0, k=k)
    assert bf16.compute_dtype == torch.bfloat16
    assert bf16.model_kw == ({"bf16_loss": True} if family == "celeba19"
                             else {})
    assert sorted(spec.data) == sorted(jdata)
    for key, v in jdata.items():
        assert spec.data[key].dtype == v.dtype, key
        np.testing.assert_array_equal(spec.data[key], v[0])
    np.testing.assert_array_equal(spec.masks, np.asarray(jmasks))
    np.testing.assert_array_equal(spec.lambdas, np.asarray(jlambdas))
    assert spec.batch == batch
    for name, got in (("recon_masks", spec.recon_masks),
                      ("recon_support", spec.recon_support)):
        if opts.get(name) is None:
            assert got is None, name
        else:
            np.testing.assert_array_equal(got, opts[name])
    assert spec.dynamic == opts.get("dynamic", False)
    np.testing.assert_array_equal(spec.idxs, jidxs)


def test_bench_is_bench_py_but_for_the_clis_term_weights():
    """tools/bench.py times bench.py's step (BATCH, N_LATENTS, masks)
    with the CelebA train CLI's term weights, image 1 and attrs 10, where
    bench.py's measure_ours weights image 10 and attrs 1: the one
    documented difference, said in the tool's unit."""
    ref = load_script("bench.py", "jax_bench")
    assert (bench.BATCH, bench.N_LATENTS) == (ref.BATCH, ref.N_LATENTS)
    src = (ROOT / "bench.py").read_text()
    assert "[[1., 1.], [1., 0.], [0., 1.]]," in src
    assert bench.MASKS == [[1.0, 1.0], [1.0, 0.0], [0.0, 1.0]]
    assert "[[10.0, 1.0]] * 3" in src
    cli = celeba_cli.parser().parse_args([])
    assert bench.LAMBDAS == [[cli.lambda_image, cli.lambda_attrs]] * 3
    assert bench.LAMBDAS == [[1.0, 10.0]] * 3
    assert bench.LR == cli.lr == 1e-4


def batch_for(model, b, seed=0):
    """b rows as the device-resident data holds them: uint8 images,
    0/1 attributes, classes or tokens."""
    rng = np.random.default_rng(seed)
    out = {}
    for key, (shape, dtype) in model.input_spec().items():
        shape = (b,) + tuple(shape)
        if key == "attrs":
            x = (rng.random(shape) < 0.3).astype(np.float32)
        elif dtype.is_floating_point:
            x = rng.integers(0, 256, shape, dtype=np.uint8)
        else:
            x = rng.integers(0, 10, shape).astype(np.int32)
        out[key] = torch.from_numpy(x)
    return out


def poe_plain_flops(t, m, b, d):
    """The products of the PoE's plain version on the CPU: poe_plain's
    masks @ (M, B*D) twice, poe_bwd_plain's four; the card's poe_fwd and
    poe_bwd kernels do that work without a product, so the FLOPs a step
    leave it out."""
    return 6 * 2 * t * m * b * d


def counted(model, masks, lambdas, b, recon_masks=None, dynamic=False,
            recon_support=None):
    """FlopCounterMode's count of one port train step at b rows on the
    CPU, and the count from shapes."""
    step = make_train_step(
        model, None if dynamic else masks, None if dynamic else lambdas,
        lr=1e-4, device="cpu", generator=torch.Generator().manual_seed(0),
        recon_masks=recon_masks, recon_support=recon_support)
    kw = {} if not dynamic else {
        "masks": torch.as_tensor(masks, dtype=torch.float32),
        "lambdas": torch.as_tensor(lambdas, dtype=torch.float32)}
    with FlopCounterMode(display=False) as counter:
        loss, _ = step(batch_for(model, b), 0.5, **kw)
    assert torch.isfinite(loss)
    poe = poe_plain_flops(np.shape(masks)[0], len(model.modalities), b,
                          model.n_latents)
    return (counter.get_total_flops() - poe,
            measure.count_step(model, masks, lambdas, b, recon_masks,
                               recon_support))


@pytest.mark.parametrize("cls", [CelebaMVAE, MnistMVAE])
def test_flops_per_step_is_the_counters_without_dead_work(cls):
    """One term that reconstructs every modality runs no dead decode:
    flops_per_step at B = 4 equals FlopCounterMode's count of the port's
    step (less the PoE's plain products)."""
    model = cls(8, device="cpu")
    got, want = counted(model, [[1.0, 1.0]], [[1.0, 10.0]], 4)
    assert want.dead == 0
    assert got == want.needed == measure.flops_per_step(
        model, [[1.0, 1.0]], [[1.0, 10.0]], 4)


def shipped(family):
    """(model, masks, lambdas, recon_masks, dynamic, recon_support) of the
    family's CLI step at width 8."""
    if family == "celeba19":
        masks, lambdas = celeba19_step_terms(np.random.default_rng(1), 1,
                                             18, 1.0, 10.0)
        return (Celeba19MVAE(8, device="cpu"), masks, lambdas, None, True,
                celeba19_recon_support(1))
    if family == "vision":
        return (VisionMVAE(8, device="cpu"), vision_cli.TERM_MASKS,
                vision_cli.TERM_LAMBDAS, vision_cli.RECON_MASKS, False,
                None)
    cls = {"celeba": CelebaMVAE, "mnist": MnistMVAE,
           "fashionmnist": FashionMnistMVAE,
           "multimnist": MultiMnistMVAE}[family]
    return cls(8, device="cpu"), MASKS, LAMBDAS, None, False, None


@pytest.mark.parametrize("family", bench_families.FAMILY_NAMES)
def test_counter_exceeds_flops_per_step_by_the_dead_decodes(family):
    """On each family's CLI step (CelebA's shipped three terms, celeba19's
    21 with the CLI's recon support, vision's seven with their recon
    masks) FlopCounterMode's count less flops_per_step is exactly the
    dead work's FLOPs from shapes: what the grouped decode runs beyond
    the need, the forward alone of a BN'd decoder for each term that
    never trains it (and celeba19's sampled term's decodes at a weight of
    0, which its support holds); on CelebA one image decode's forward
    (the attrs-only term) and one attribute decode's (the image-only
    term), no backward; none on the MNIST families, whose dead decoders
    are stateless and skipped."""
    model, masks, lambdas, recon, dynamic, support = shipped(family)
    got, want = counted(model, masks, lambdas, 4, recon, dynamic, support)
    assert got - want.needed == want.dead == measure.dead_decode_flops(
        model, masks, lambdas, 4, recon, support)
    if family == "celeba":
        assert want.dead == want.forward["image"] + want.forward["attrs"]
        assert 0 < want.dead < want.decode["image"] + want.decode["attrs"]
    if family in ("vision", "mnist", "fashionmnist"):
        assert want.dead == 0
    assert want.needed > want.encode > 0


def test_count_refuses_stacked_modalities():
    model = VisionMVAE(8, stack_modalities=True, device="cpu")
    with pytest.raises(ValueError, match="stack_modalities"):
        measure.flops_per_step(model, vision_cli.TERM_MASKS,
                               vision_cli.TERM_LAMBDAS, 2,
                               vision_cli.RECON_MASKS)


def test_mnist_count_is_at_most_xlas_cost_analysis():
    """MNIST at B = 4, the bench width: the port's FLOPs a step are at most
    XLA's cost analysis of the JAX package's K = 1 window at the same
    shapes, lowered on the CPU as scripts/bench_families.py:153-167 lowers
    it (XLA's count also holds the elementwise work, the loss and Adam)."""
    b = 4
    jmodel = JaxMnistMVAE(64, compute_dtype=jnp.float32)
    tx = optax.adam(1e-4)
    params, state = jmodel.init(jax.random.key(0))
    rng = np.random.default_rng(0)
    data = {"image": jax.device_put((rng.random((1, 16, 784)) * 255)
                                    .astype(np.uint8)),
            "text": jax.device_put(rng.integers(0, 10, (1, 16))
                                   .astype(np.int32))}
    multi = jax_multi_step(jmodel, tx, MASKS, LAMBDAS)
    cost = multi.lower(params, state, tx.init(params), jax.random.key(6),
                       data, jnp.asarray(rng.integers(0, 16, (1, 1, b)),
                                         jnp.int32),
                       jnp.full((1,), 0.5, jnp.float32)
                       ).compile().cost_analysis()
    cost = cost[0] if isinstance(cost, (list, tuple)) else cost
    ours = measure.flops_per_step(MnistMVAE(64, torch.float32, device="cpu"),
                                  MASKS, LAMBDAS, b)
    ratio = ours / cost["flops"]
    assert 0.5 < ratio <= 1.0, (
        f"port {ours} FLOPs a step against XLA's {cost['flops']}: ratio "
        f"{ratio}")


TOOLS = [
    (bench, ["--k", "1", "--windows", "1", "--warmup", "1"]),
    (bench_families, ["--k", "1", "--families", "mnist", "--flops"]),
    (roofline_family, ["--family", "mnist", "--k", "1", "--top", "3"]),
    (serve_latency, ["--model", "mnist"]),
]


@pytest.fixture
def small(monkeypatch):
    """The tools at a CPU's size: the CelebA bench at B = 4, L = 8 on 16
    rows; three calls an endpoint."""
    monkeypatch.setattr(bench, "BATCH", 4)
    monkeypatch.setattr(bench, "N_LATENTS", 8)
    monkeypatch.setattr(bench, "N_ROWS", 16)
    monkeypatch.setattr(serve_latency, "CALLS", 3)


@pytest.mark.parametrize("tool,argv", TOOLS,
                         ids=[t.__name__.split(".")[-1] for t, _ in TOOLS])
def test_tools_raise_without_a_card_and_say_cpu_on_it(
        monkeypatch, capsys, small, tool, argv):
    """Without a card each tool raises before it builds anything, unless
    --device cpu; on the CPU every JSON line it prints is what it returns,
    says device "cpu" and holds null for every device metric."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(measure, "smi_line", lambda: 1 / 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tool.main(argv)
    out = tool.main(argv + ["--device", "cpu"])
    records = out if isinstance(out, list) else [out]
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith("{")]
    assert lines == records and records
    for rec in records:
        assert rec["device"] == "cpu"
        for key in DEVICE_METRICS:
            assert rec.get(key) is None, key
    if tool is bench:
        rec = records[0]
        assert rec["metric"] == "celeba_train_steps_per_sec"
        assert rec["windows"]["count"] == 2 and rec["vs_baseline"] > 0
        assert "image 1, attrs 10" in rec["unit"]
        assert rec["flops_per_step"] == measure.flops_per_step(
            CelebaMVAE(8, torch.bfloat16, device="cpu"), MASKS, LAMBDAS, 4)
    if tool is serve_latency:
        # the prior, and a sample, embed and reconstruct a modality, at
        # buckets 1 and 64
        assert len(records) == 2 * (1 + 3 * 2)
        assert all(r["calls"] == 3 and 0 < r["p50_ms"] <= r["p95_ms"]
                   for r in records)


def test_reference_flow_runs_three_forwards_a_step(monkeypatch):
    """The reference flow's step is three forwards (joint, image only,
    attrs only) and one Adam step: its losses are finite and its
    parameters move."""
    monkeypatch.setattr(bench, "BATCH", 4)
    monkeypatch.setattr(bench, "N_LATENTS", 8)
    flow = bench.ReferenceFlow(torch.device("cpu"), seed=0, k=2)
    calls = []
    flow.model.register_forward_hook(
        lambda m, a, o: calls.append(tuple(x is not None for x in a)))
    before = [p.detach().clone() for p in flow.model.parameters()]
    losses = flow.window()()
    assert losses.shape == (2,) and bool(torch.isfinite(losses).all())
    assert len(calls) == 6
    assert any(not torch.equal(a, b.detach())
               for a, b in zip(before, flow.model.parameters()))
    # forward(image, attrs), forward(image, None), forward(None, attrs)
    assert calls[:3] == [(True, True), (True, False), (False, True)]


def test_kernel_families_name_the_port_kernels_as_perf_md():
    """measure.FAMILIES maps the device names of the port's eight kernels
    (csrc/*.cu) to the names PERF.md's kernel table gives them, and the
    library kernels to the families of PERF.md section 5's breakdowns."""
    names = {
        "void poe_fwd_kernel<2>(float const*, float const*, float const*, "
        "float*, float*, int, int, int)": "poe_fwd",
        "void poe_bwd_kernel<32>(float const*, float const*)": "poe_bwd",
        "void bce_rowsum_kernel<__nv_bfloat16, __nv_bfloat16, 8, false>("
        "__nv_bfloat16 const*)": "bce_rowsum_fwd",
        "void bn_reduce_kernel<MomentsOp, __nv_bfloat16, 8, false>("
        "MomentsOp, __nv_bfloat16 const*)": "bn_moments",
        "void bn_reduce_kernel<PartialsOp, float, 4, true>(PartialsOp, "
        "float const*)": "bn_bwd_partials",
        "void bn_normalize_kernel<__nv_bfloat16, 8, true>(__nv_bfloat16 "
        "const*, __nv_bfloat16*, NormalizeOp, int, int, Stream)":
            "bn_normalize",
        "void bn_dx_kernel<float, 4, false>(float const*)": "bn_dx",
        "void conv_moments_bf16_kernel<64, 2>(__nv_bfloat16 const*)":
            "conv2d_moments",
        "conv_moments_f32_kernel(float const*, float const*, float*)":
            "conv2d_moments",
        "sm90_xmma_wgrad_implicit_gemm_indexed_bf16bf16_bf16f32_f32_nhwckrsc"
        "_nhwc": "conv (cuDNN)",
        "void cudnn::engines_precompiled::nchwToNhwcKernel<float>":
            "conv (cuDNN)",
        "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64":
            "gemm (cuBLAS)",
        "void at::native::(anonymous namespace)::multi_tensor_apply_kernel"
        "<at::native::(anonymous namespace)::TensorListMetadata<4>>":
            "adam (foreach)",
        "void at::native::vectorized_elementwise_kernel<4, at::native::"
        "CUDAFunctor_add<float>>": "elementwise / copy",
        "void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float>"
        ">": "reduce",
        "ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage)":
            "all-reduce (NCCL)",
    }
    for kernel, family in names.items():
        assert measure.family_of(kernel) == family, kernel
    src = "\n".join(p.read_text() for p in
                    (ROOT / "mvae_tpu_torch" / "csrc").glob("*.cu"))
    for fn in ("poe_fwd_kernel", "poe_bwd_kernel", "bce_rowsum_kernel",
               "bn_reduce_kernel", "bn_normalize_kernel", "bn_dx_kernel",
               "conv_moments_bf16_kernel", "conv_moments_f32_kernel",
               "MomentsOp", "PartialsOp"):
        assert re.search(rf"\b{fn}\b", src), fn
    table = (ROOT / "PERF.md").read_text()
    assert set(measure.PORT_KERNELS) == set(names.values()) & set(
        measure.PORT_KERNELS)
    for name in measure.PORT_KERNELS:
        assert f"`{name}`" in table or f" {name} " in table, name
