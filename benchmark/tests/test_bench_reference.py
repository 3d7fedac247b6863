"""The plain references against the port on the CPU at a small batch, both
in float32: one train step's loss, every parameter's gradient and the
BatchNorm running statistics after it (CelebA, celeba19 and a
vision-shaped configuration with recon_masks and six dropout encoders),
and one IWAE estimate with the same injected noise; the reference's
gradient taken a term at a time against its whole graph's."""

import json

import pytest
import torch

from conftest import BENCH, vision_config
from harness import cell_train, inputs
from reference import common

ROWS = 6


def setup(name, seed=7):
    cfg = (vision_config() if name == "vision" else
           json.loads((BENCH / "configs" / f"{name}.json").read_text()))
    cfg["compute_dtype"] = {"train": "float32", "score": "float32"}
    cpu = torch.device("cpu")
    state = inputs.make_weights(cfg, seed, cpu)
    model = cell_train.port_model(cfg, "train", cpu, state)
    fam = __import__(f"reference.{cfg['reference']}",
                     fromlist=["Model"]).Model(cfg)
    rows = inputs.make_rows(cfg, ROWS, seed, cpu)
    return cfg, model, fam, inputs.make_weights(cfg, seed, cpu), rows


@pytest.mark.parametrize("name", ["celeba", "celeba19", "vision"])
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
    r_t = (None if terms.recon_masks is None
           else torch.from_numpy(terms.recon_masks))
    support = terms.support()

    model.train()
    batch = decode_batch(dict(rows), torch.float32)
    total, _ = multi_term_elbo(model, batch, m_t, l_t, 1.0, train=True,
                               noise=(eps, keep),
                               plan=decode_plan(model, support),
                               recon_masks=r_t)
    total.backward()

    names = [k for k in params if params[k].is_floating_point()
             and common.trained(k)]
    for k in names:
        params[k].requires_grad_(True)
    bn = common.BNState()
    ref_total, _ = common.elbo(fam, params, common.Ops(),
                               cell_train.as_float(cfg, rows), m_t, l_t, 1.0,
                               eps, keep, bn, r_t)
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


@pytest.mark.parametrize("name", ["celeba", "celeba19", "vision"])
def test_gradient_a_term_at_a_time_is_the_whole_graphs(name):
    cfg, _, fam, params, rows = setup(name, seed=4)
    terms = inputs.Terms(cfg, 4)
    masks, lambdas = (torch.from_numpy(a) for a in terms.step())
    recon = (None if terms.recon_masks is None
             else torch.from_numpy(terms.recon_masks))
    eps, keep = cell_train.step_noise(cfg, torch.Generator().manual_seed(2),
                                      masks.shape[0], ROWS,
                                      torch.device("cpu"))
    x = cell_train.as_float(cfg, rows)
    names = [k for k in params if params[k].is_floating_point()
             and common.trained(k)]
    for k in names:
        params[k].requires_grad_(True)
    args = (fam, params, common.Ops(), x, masks, lambdas, 1.0, eps, keep)
    whole, per_term = common.elbo(*args, common.BNState(), recon)
    want = torch.autograd.grad(whole, [params[k] for k in names],
                               allow_unused=True)
    total, per_term2, got = common.elbo(*args, common.BNState(), recon,
                                        wrt=names)
    assert float(total) == float(whole.detach())
    assert torch.equal(per_term2, per_term.detach())
    scale = max(float(g.abs().max()) for g in want if g is not None)
    for k, w in zip(names, want):
        assert (w is None) == (got[k] is None), k
        if w is not None:
            assert torch.allclose(got[k], w, rtol=1e-5, atol=1e-6 * scale), k


def test_weights_load_strictly_into_the_port():
    """The configuration's stacks name every tensor of the port's models,
    with the port's shapes (load_state_dict(strict=True) in setup)."""
    for name in ("celeba", "celeba19", "vision"):
        cfg, model, _, params, _ = setup(name)
        assert set(model.state_dict()) == set(params)
