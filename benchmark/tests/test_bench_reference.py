"""The plain references against the port on the CPU at a small batch, both
in float32: one train step's loss, every parameter's gradient and the
BatchNorm running statistics after it, and one IWAE estimate with the
same injected noise."""

import json

import numpy as np
import pytest
import torch

from conftest import BENCH
from harness import cell_train, inputs
from reference import common

ROWS = 6


def setup(name, seed=7):
    cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    cfg["compute_dtype"] = {"train": "float32", "score": "float32"}
    cpu = torch.device("cpu")
    state = inputs.make_weights(cfg, seed, cpu)
    model = cell_train.port_model(cfg, "train", cpu, state)
    fam = __import__(f"reference.{cfg['reference']}",
                     fromlist=["Model"]).Model(cfg)
    rows = inputs.make_rows(cfg, ROWS, seed, cpu)
    return cfg, model, fam, inputs.make_weights(cfg, seed, cpu), rows


@pytest.mark.parametrize("name", ["celeba", "celeba19"])
def test_train_step_matches_reference(name):
    from mvae_tpu_torch.core.engine import decode_plan, multi_term_elbo
    from mvae_tpu_torch.train.loop import decode_batch
    cfg, model, fam, params, rows = setup(name)
    terms = inputs.Terms(cfg, 11)
    masks, lambdas = terms.step()
    gen = torch.Generator().manual_seed(5)
    eps, keep = cell_train.step_noise(cfg, gen, masks.shape[0], ROWS,
                                      torch.device("cpu"))
    m_t, l_t = torch.from_numpy(masks), torch.from_numpy(lambdas)
    support = terms.support() if terms.dynamic else (
        masks * lambdas != 0).astype(np.float32)

    model.train()
    batch = decode_batch(dict(rows), torch.float32)
    total, _ = multi_term_elbo(model, batch, m_t, l_t, 1.0, train=True,
                               noise=(eps, keep),
                               plan=decode_plan(model, support))
    total.backward()

    names = [k for k in params if params[k].is_floating_point()
             and common.trained(k)]
    for k in names:
        params[k].requires_grad_(True)
    bn = common.BNState()
    ref_total, _ = common.elbo(fam, params, common.Ops(),
                               cell_train.as_float(cfg, rows), m_t, l_t, 1.0,
                               eps, keep, bn)
    grads = torch.autograd.grad(ref_total, [params[k] for k in names],
                                allow_unused=True)
    with torch.no_grad():
        bn.apply(params)

    assert float(total.detach()) == pytest.approx(float(ref_total.detach()),
                                                 rel=1e-5)
    port = dict(model.named_parameters())
    scale = max(float(g.abs().max()) for g in grads if g is not None)
    for k, g in zip(names, grads):
        g = torch.zeros_like(params[k]) if g is None else g
        pg = port[k].grad if port[k].grad is not None else torch.zeros_like(g)
        assert torch.allclose(pg, g, rtol=1e-3, atol=1e-5 * scale), k
    sd = model.state_dict()
    for k in params:
        if k.endswith(("running_mean", "running_var")):
            assert torch.allclose(sd[k], params[k], rtol=1e-5, atol=1e-6), k


@pytest.mark.parametrize("name", ["celeba", "celeba19"])
def test_iwae_matches_reference(name):
    from mvae_tpu_torch.core.loglike import iwae_log_marginal
    from mvae_tpu_torch.train.loop import decode_batch
    cfg, model, fam, params, rows = setup(name, seed=9)
    k = 5
    eps = torch.randn((k, ROWS, cfg["n_latents"]),
                      generator=torch.Generator().manual_seed(3))
    proposal = cfg["score"]["proposal"]
    got = iwae_log_marginal(model, decode_batch(dict(rows), torch.float32),
                            proposal, cfg["score"]["targets"], k, eps=eps)
    want = common.iwae(fam, params, common.Ops(),
                       cell_train.as_float(cfg, rows),
                       torch.tensor(proposal, dtype=torch.float32),
                       cfg["score"]["targets"], eps, block=2)
    assert torch.allclose(got, want, rtol=1e-6, atol=0), (got, want)


def test_weights_load_strictly_into_the_port():
    """The configuration's stacks name every tensor of the port's models,
    with the port's shapes (load_state_dict(strict=True) in setup)."""
    for name in ("celeba", "celeba19"):
        cfg, model, _, params, _ = setup(name)
        assert set(model.state_dict()) == set(params)
