"""The control of each cell's comparison, on the card at the cell's own
size: the plain reference in the precision below the configuration's
(bf16 training: fp8 e4m3 operands and inputs; float32 scoring: TF32) put
in the program's place fails the cell's limits on three seeds, while the
program passes them."""

import argparse
import json

import pytest

from conftest import BENCH

SEEDS = (3300000001, 3300000003, 3300000005)


def cell(name):
    spec = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    w = {c["name"]: c for c in spec["workloads"]}[name]
    cfg = json.loads((BENCH / "configs" / f"{w['config']}.json").read_text())
    traffic = json.loads((BENCH / "traffic" /
                          f"{w['traffic']}.json").read_text())
    return cfg, traffic


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["celeba.train.b4096",
                                  "celeba19.train.b2048"])
def test_training_control_fails(card, name):
    from harness import cell_train, checks
    cfg, traffic = cell(name)
    limits = checks.load_limits(BENCH, name)
    for seed in SEEDS:
        prog = cell_train.Program(cfg, traffic, seed, card)
        prog.free()
        ref = prog.reference(cfg, seed)
        assert checks.verdict(checks.train_numbers(prog.prog, ref),
                              limits)[0]
        ctl = prog.reference(cfg, seed, "fp8_e4m3")
        assert not checks.verdict(checks.train_numbers(ctl, ref), limits)[0]


@pytest.mark.cuda
def test_scoring_control_fails(card):
    import run
    from harness import cell_score, checks
    name = "celeba.score.k100"
    cfg, traffic = cell(name)
    limits = checks.load_limits(BENCH, name)
    for seed in SEEDS:
        ctx = run.Context(argparse.Namespace(seed=seed, seconds=2.0,
                                             trace=0), cfg, traffic, card)
        out = cell_score.run(ctx)
        assert checks.verdict(out["numbers"], limits)[0]
        c = out["check"]
        ctl = cell_score.reference_scores(cfg, seed, card, c["rows"],
                                          c["picks"], c["states"],
                                          c["samples"], precision="tf32")
        assert not checks.verdict(checks.score_numbers(ctl, c["ref"]),
                                  limits)[0]
