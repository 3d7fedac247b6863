"""The benchmark's operation counts from the configurations' shapes
against the port's own counts (tools/measure.py:count_step) and
FlopCounterMode, and the port kernels' per-launch costs."""

import json

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from conftest import BENCH, vision_config
from harness import cell_train, inputs, port_calls, yardstick
from reference import common

CELEBA_B100 = 60028108800      # measure.flops_per_step at B = 100
# each cell's operations, as the parent of recon_masks counted them: the
# first 11 steps of the feed at seed 3000000019 (training), one batch
# (scoring)
CELL_COUNTS = {"celeba.train.b4096": 27046264700928,
               "celeba19.train.b2048": 18867459981312,
               "celeba.score.k100": 648987648000}


def config(name):
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


def port(cfg):
    cpu = torch.device("cpu")
    return cell_train.port_model(cfg, "train", cpu,
                                 inputs.make_weights(cfg, 1, cpu))


def test_celeba_train_flops_equal_the_ports_count():
    from mvae_tpu_torch.tools import measure
    cfg = config("celeba")
    t = cfg["terms"]
    weights = np.asarray(t["masks"]) * np.asarray(t["lambdas"])
    ours = yardstick.train_step_flops(cfg, 100, weights)
    assert ours == CELEBA_B100
    assert ours == measure.flops_per_step(port(cfg), t["masks"],
                                          t["lambdas"], 100)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_celeba19_train_flops_equal_the_ports_count(seed):
    from mvae_tpu_torch.tools import measure
    cfg = config("celeba19")
    terms = inputs.Terms(cfg, seed)
    masks, lambdas = terms.step()
    ours = yardstick.train_step_flops(cfg, 100, masks * lambdas)
    theirs = measure.count_step(port(cfg), masks, lambdas, 100,
                                recon_support=terms.support()).needed
    assert ours == theirs


@pytest.mark.parametrize("name", ["celeba", "celeba19"])
def test_score_flops_equal_flop_counter_on_the_reference(name):
    cfg = config(name)
    rows, k = 3, 4
    cpu = torch.device("cpu")
    fam = __import__(f"reference.{cfg['reference']}",
                     fromlist=["Model"]).Model(cfg)
    params = inputs.make_weights(cfg, 2, cpu)
    x = cell_train.as_float(cfg, inputs.make_rows(cfg, rows, 2, cpu))
    eps = torch.randn((k, rows, cfg["n_latents"]))
    with FlopCounterMode(display=False) as fc:
        common.iwae(fam, params, common.Ops(), x,
                    torch.tensor(cfg["score"]["proposal"],
                                 dtype=torch.float32),
                    cfg["score"]["targets"], eps, block=k)
    assert yardstick.score_flops(cfg, rows, k) == fc.get_total_flops()


@pytest.mark.parametrize("workload", sorted(CELL_COUNTS))
def test_cells_count_the_parents_operations(workload):
    spec = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    cell = {w["name"]: w for w in spec["workloads"]}[workload]
    cfg = config(cell["config"])
    traffic = json.loads((BENCH / "traffic" /
                          f"{cell['traffic']}.json").read_text())
    if traffic["loop"] == "score":
        count = yardstick.score_flops(cfg, traffic["batch"],
                                      traffic["samples"])
    else:
        feed = cell_train.Feed(cfg, traffic, 3000000019,
                               torch.device("cpu"))
        feed.take(1)
        feed.take(10)
        count = sum(yardstick.train_step_flops(cfg, traffic["batch"], w)
                    for w in feed.weights)
    assert count == CELL_COUNTS[workload]


def by_hand(cfg, rows, live):
    """A train step's operations from stack_products alone: each expert's
    encoder forward and backward (its first product's input, the data,
    takes no gradient) and `live` decodes of its decoder, forward and
    backward."""
    total = 0
    for e in cfg["experts"]:
        shape = tuple(cfg["inputs"][e["name"]]["shape"])
        first = True
        for s in e["encoder"]:
            products, shape = yardstick.stack_products(cfg["stacks"][s],
                                                       shape)
            for _, macs in products:
                total += 2 * macs * (2 if first else 3)
                first = False
        shape = (cfg["n_latents"],)
        for s in e["decoder"]:
            products, shape = yardstick.stack_products(cfg["stacks"][s],
                                                       shape)
            total += live * sum(3 * 2 * macs for _, macs in products)
    return rows * total


def test_all_ones_recon_masks_count_seven_decodes_a_decoder():
    """Vision's seven terms each reconstruct all six modalities: seven
    live decodes a decoder; with its posterior masks alone, two (the
    joint term and the modality's own)."""
    cfg = vision_config(250)
    terms = inputs.Terms(cfg, 0)
    weights = terms.recon_weights(*terms.step())
    assert weights.shape == (7, 6) and (weights != 0).all()
    ours = yardstick.train_step_flops(cfg, 100, weights)
    assert ours == by_hand(cfg, 100, 7)
    del cfg["terms"]["recon_masks"]
    terms = inputs.Terms(cfg, 0)
    assert yardstick.train_step_flops(
        cfg, 100, terms.recon_weights(*terms.step())) == by_hand(cfg, 100, 2)


def test_vision_train_flops_equal_flop_counter_on_the_reference():
    """FlopCounterMode over the reference's step (forward and the
    backward a term at a time) counts what the yardstick counts."""
    cfg = vision_config(8)
    rows, cpu = 2, torch.device("cpu")
    fam = __import__("reference.celeba", fromlist=["Model"]).Model(cfg)
    params = inputs.make_weights(cfg, 3, cpu)
    names = [k for k in params if params[k].is_floating_point()
             and common.trained(k)]
    for k in names:
        params[k].requires_grad_(True)
    x = cell_train.as_float(cfg, inputs.make_rows(cfg, rows, 3, cpu))
    terms = inputs.Terms(cfg, 3)
    masks, lambdas = (torch.from_numpy(a) for a in terms.step())
    eps, keep = cell_train.step_noise(cfg, torch.Generator(), 7, rows, cpu)
    with FlopCounterMode(display=False) as fc:
        common.elbo(fam, params, common.Ops(), x, masks, lambdas, 1.0, eps,
                    keep, common.BNState(),
                    torch.from_numpy(terms.recon_masks), wrt=names)
    assert fc.get_total_flops() == yardstick.train_step_flops(
        cfg, rows, terms.recon_weights(masks.numpy(), lambdas.numpy()))


def test_kernel_costs():
    bf16, f32 = (2, "torch.bfloat16"), (4, "torch.float32")
    x = ((3, 100, 32, 1024), *bf16)
    vec = ((3, 32), *f32)
    call = {"name": "bn_normalize",
            "args": (x, vec, vec, 3276800, ((32,), *f32), ((32,), *f32)),
            "out": (x, vec, vec, vec, vec, vec)}
    flops, nbytes, peak = port_calls.kernel_cost(call)
    n = 3 * 100 * 32 * 1024
    vectors = 7 * 3 * 32 * 4 + 2 * 32 * 4
    assert (flops, nbytes, peak) == (0, 2 * 2 * n + vectors, 989e12)
    conv = {"name": "conv2d_moments",
            "args": (((100, 32, 32, 32), *bf16), ((64, 32, 4, 4), *bf16),
                     2, 1),
            "out": (((100, 64, 16, 16), *bf16), ((64,), *f32), ((64,), *f32))}
    flops, nbytes, _ = port_calls.kernel_cost(conv)
    assert flops == 2 * 100 * 16 * 16 * 64 * 32 * 16
    assert nbytes == 2 * (100 * 32 * 32 * 32 + 64 * 32 * 16
                          + 100 * 64 * 16 * 16) + 2 * 64 * 4
    assert port_calls.least_seconds(conv) == pytest.approx(
        max(flops / 989e12, nbytes / 3.35e12))


def test_recorder_spans_the_ports_kernel_calls():
    """The benchmark's wrappers stand in the port's ops modules inside the
    block and the port's own entries come back after it. On the CPU the
    kernels' plain versions run and are wrapped alike: a train step's
    calls, each with its arguments' shapes."""
    from mvae_tpu_torch.core.engine import multi_term_elbo
    from mvae_tpu_torch.ops import bn, elbo
    own = (bn.bn_moments_plain, bn._PASSES, elbo.bce_rowsum_fwd,
           elbo.bce_rowsum_fwd.launches)
    cfg = config("celeba")
    model = port(cfg)
    model.train()
    rows = cell_train.as_float(cfg, inputs.make_rows(
        cfg, 4, 1, torch.device("cpu")))
    masks = torch.tensor(cfg["terms"]["masks"], dtype=torch.float32)
    lambdas = torch.tensor(cfg["terms"]["lambdas"], dtype=torch.float32)
    eps, keep = cell_train.step_noise(cfg, torch.Generator(), 3, 4,
                                      torch.device("cpu"))
    with port_calls.recording() as rec:
        assert bn.bn_moments_plain is not own[0]
        assert bn._PASSES[False][0] is bn.bn_moments_plain
        total, _ = multi_term_elbo(model, rows, masks, lambdas, 1.0,
                                   train=True, noise=(eps, keep))
        total.backward()
    assert (bn.bn_moments_plain, bn._PASSES, elbo.bce_rowsum_fwd,
            elbo.bce_rowsum_fwd.launches) == own
    names = {c["name"] for c in rec.calls}
    assert {"poe_fwd", "poe_bwd", "bce_rowsum_fwd", "bn_moments",
            "bn_normalize", "bn_bwd_partials", "bn_dx"} <= names
    assert all(c["out"] is not None for c in rec.calls)
    for c in rec.calls:
        assert port_calls.least_seconds(c) > 0


def test_recorder_raises_where_the_port_lost_an_entry(monkeypatch):
    from mvae_tpu_torch.ops import poe
    monkeypatch.delattr(poe, "poe_bwd")
    from mvae_tpu_torch.ops import bn
    own = bn.bn_dx
    with pytest.raises(RuntimeError, match="poe_bwd"):
        with port_calls.recording():
            pass
    assert bn.bn_dx is own
