"""The Vision MVAE's configuration of the port's benchmark
(benchmark/configs/vision.json: VisionMVAE(250) at its published widths)
against its plain reference (benchmark/reference/vision.py) on the CPU,
at a batch of 3 rows: one float32 train step, the weights' names, the
encoders' dropout, the yardstick's count of a step's operations, and the
cell vision.train.b2048 run by name with its rows cut.

The benchmark's folder is put on sys.path, as its own tests' conftest
puts it; its helpers are loaded from there under another module name.
"""

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "benchmark"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from harness import cell_train, inputs, yardstick  # noqa: E402
from reference import common  # noqa: E402

CELL = "vision.train.b2048"
ROWS = 3
CPU = torch.device("cpu")


def bench_helpers():
    """benchmark/tests/conftest.py's make_checkout and run_cell."""
    spec = importlib.util.spec_from_file_location(
        "bench_conftest", BENCH / "tests" / "conftest.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def config():
    return json.loads((BENCH / "configs" / "vision.json").read_text())


def test_the_cell_names_the_configuration_and_its_reference():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = {w["name"]: w for w in spec["workloads"]}[CELL]
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "vision", "train_b2048", 1)
    entry = {c["name"]: c for c in spec["configs"]}["vision"]
    assert entry["file"] == "benchmark/configs/vision.json"
    assert entry["reduced"] == []
    cfg = config()
    assert cfg["reference"] == "vision" and cfg["n_latents"] == 250
    assert cfg["port"]["model"] == "mvae_tpu_torch.models.vision:VisionMVAE"
    assert cfg["compute_dtype"]["train"] == "bfloat16"
    assert (BENCH / "limits" / f"{CELL}.json").is_file()


def test_weights_load_strictly_and_the_stacks_name_every_tensor():
    cfg = config()
    state = inputs.make_weights(cfg, 5, CPU)
    model = cell_train.port_model(cfg, "train", CPU, state)
    assert set(model.state_dict()) == set(state)
    for k, v in model.state_dict().items():
        assert v.shape == state[k].shape, k
    assert model.image_encoder.classifier[-1].weight.shape == (500, 512)
    assert model.gray_decoder.upsample[0].weight.shape == (6400, 250)


def test_keep_spec_is_one_row_for_each_of_six_encoders():
    cfg = config()
    assert inputs.keep_spec(cfg) == (6, 512, 0.1)
    model = cell_train.port_model(cfg, "train", CPU,
                                  inputs.make_weights(cfg, 5, CPU))
    assert model.keep_mask_shape(ROWS) == (6, ROWS, 512)


def test_the_yardsticks_count_of_a_step():
    """Operations a row of a step, reckoned by hand (2 a multiply-add; a
    product's backward counts it again for each operand that needs a
    gradient: every weight, and the input of all but an encoder's first
    conv). An encoder of C channels, forward multiply-adds a row:

        conv C->32 to 32x32      32*32*32*C*16  =    524 288 C
        conv 32->64 to 16x16     16*16*64*32*16 =  8 388 608
        conv 64->128 to 8x8       8*8*128*64*16 =  8 388 608
        conv 128->256 to 5x5    5*5*256*128*16  = 13 107 200
        fc 6400->512, 512->500                  =  3 532 800

    so forward and backward 2 (2 * 524 288 C + 3 * 33 417 216) =
    2 097 152 C + 200 503 296. A decoder: fc 250->6400 1 600 000, convT
    from 5x5, 8x8, 16x16 and 32x32 inputs 13 107 200 + 8 388 608 +
    8 388 608 + 524 288 C, 31 484 416 + 524 288 C in all, times 6 for its
    forward and backward. Each decoder runs live in all 7 terms, each
    encoder once: a modality costs 1 522 848 768 + 24 117 248 C, and the
    six (C summing to 12) 9 137 092 608 + 289 406 976 = 9 426 499 584 a
    row, 19.3 TFLOP a step at B = 2048."""
    cfg = config()
    terms = inputs.Terms(cfg, 1)
    weights = terms.recon_weights(*terms.step())
    assert weights.shape == (7, 6) and np.all(weights == np.float32(1 / 6))
    assert yardstick.train_step_flops(cfg, 1, weights) == 9_426_499_584
    assert yardstick.train_step_flops(cfg, 2048, weights) == \
        2048 * 9_426_499_584


def test_one_float32_train_step_matches_the_reference():
    """The port's step (the engine's one-batch decode: the plan is None,
    every decoder live in every term) and the reference's, in float32 at
    the published widths, on the same weights, rows, terms and noise."""
    from mvae_tpu_torch.core.engine import decode_plan, multi_term_elbo
    from mvae_tpu_torch.train.loop import decode_batch
    from reference.vision import Model
    cfg = config()
    cfg["compute_dtype"] = {"train": "float32"}
    state = inputs.make_weights(cfg, 7, CPU)
    model = cell_train.port_model(cfg, "train", CPU, state)
    params = inputs.make_weights(cfg, 7, CPU)
    rows = inputs.make_rows(cfg, ROWS, 7, CPU)
    terms = inputs.Terms(cfg, 11)
    masks, lambdas = terms.step()
    m_t, l_t = torch.from_numpy(masks), torch.from_numpy(lambdas)
    r_t = torch.from_numpy(terms.recon_masks)
    eps, keep = cell_train.step_noise(cfg, torch.Generator().manual_seed(5),
                                      masks.shape[0], ROWS, CPU)
    assert keep.shape == (6, ROWS, 512)
    plan = decode_plan(model, terms.support())
    assert plan is None

    model.train()
    total, _ = multi_term_elbo(model, decode_batch(dict(rows), torch.float32),
                               m_t, l_t, 1.0, train=True, noise=(eps, keep),
                               plan=plan, recon_masks=r_t)
    total.backward()

    names = [k for k in params if params[k].is_floating_point()
             and common.trained(k)]
    for k in names:
        params[k].requires_grad_(True)
    bn = common.BNState()
    ref_total, _, grads = common.elbo(
        Model(cfg), params, common.Ops(), cell_train.as_float(cfg, rows),
        m_t, l_t, 1.0, eps, keep, bn, r_t, wrt=names)
    with torch.no_grad():
        bn.apply(params)

    # the same sums in float32, in another order: a few ulps of the total
    assert float(total.detach()) == pytest.approx(float(ref_total), rel=1e-5)
    port = dict(model.named_parameters())
    scale = max(float(g.abs().max()) for g in grads.values() if g is not None)
    for k in names:
        g = grads[k] if grads[k] is not None else torch.zeros_like(params[k])
        pg = port[k].grad if port[k].grad is not None else torch.zeros_like(g)
        # float32 round-off through 42 decodes and 12 BatchNorm backwards;
        # a leaf near 0 is held against the largest gradient instead
        assert torch.allclose(pg, g, rtol=1e-3, atol=1e-5 * scale), k
    sd = model.state_dict()
    stats = [k for k in params if k.endswith(("running_mean",
                                              "running_var"))]
    assert len(stats) == 2 * 6 * 6
    for k in stats:
        # the batch statistics' float32 sums, committed twice an encoder
        # and seven times a decoder
        assert torch.allclose(sd[k], params[k], rtol=1e-5, atol=1e-6), k


def test_the_reference_loads_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import reference.vision\n"
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"
            % str(BENCH))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=300).stdout.split()
    assert "torch" in out
    assert not set(out) & {"jax", "jaxlib", "flax", "mvae_tpu",
                           "mvae_tpu_torch", "harness"}


def test_the_cell_runs_by_name_on_the_cpu(tmp_path):
    """The real configuration and limits, bf16, its traffic cut to 4 rows
    a step, 2 steps a window and 64 rows: a line with correct true."""
    helpers = bench_helpers()
    root = helpers.make_checkout(tmp_path / "checkout")
    rc, line, err = helpers.run_cell(root, CELL)
    assert rc == 0, err[-3000:]
    assert line["correct"] is True, line["checks"]
    assert set(line["metrics"]) == {"train_samples_per_s", "setup_s"}
    assert line["metrics"]["train_samples_per_s"]["value"] > 0
    assert set(line["checks"]) == {"loss_gap", "grad_gap", "change_gap"}


def test_a_recon_masks_of_the_wrong_shape_is_refused_by_name(tmp_path):
    helpers = bench_helpers()
    root = helpers.make_checkout(tmp_path / "checkout")
    path = root / "benchmark" / "configs" / "vision.json"
    cfg = json.loads(path.read_text())
    cfg["terms"]["recon_masks"] = cfg["terms"]["recon_masks"][:6]
    path.write_text(json.dumps(cfg))
    rc, line, err = helpers.run_cell(root, CELL)
    assert rc == 2 and line is None
    assert "terms.recon_masks" in err and "[6, 6]" in err
    assert "model built" not in err
