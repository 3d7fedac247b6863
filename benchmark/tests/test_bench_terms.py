"""What a configuration states of its terms and its dropout reaches the
program and the plain reference alike: `terms.recon_masks`, the modalities
each term reconstructs, and one keep-mask row an encoder where several
encoders hold a dropout, drawn as the port's model draws it. What the
harness cannot run as stated is refused before anything is built."""

import json

import numpy as np
import pytest
import torch

from conftest import BENCH, add_cell, run_cell, vision_config
from harness import cell_train, inputs


def config(name):
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


def port(cfg):
    cpu = torch.device("cpu")
    return cell_train.port_model(cfg, "train", cpu,
                                 inputs.make_weights(cfg, 1, cpu))


@pytest.mark.parametrize("name", ["celeba", "celeba19", "vision"])
def test_step_noise_is_the_ports_draw(name):
    """The same generator state gives the harness's noise and the port's
    draw_noise alike: eps, then the keep-mask in one call, (B, width) for
    one dropout encoder, (6, B, width) for vision's six."""
    from mvae_tpu_torch.train.loop import draw_noise
    cfg = vision_config() if name == "vision" else config(name)
    model = port(cfg)
    t, b = len(cfg["terms"]["masks"]), 3
    eps, keep = cell_train.step_noise(
        cfg, torch.Generator().manual_seed(17), t, b, torch.device("cpu"))
    p_eps, p_keep = draw_noise(model, t, b,
                               torch.Generator().manual_seed(17))[:2]
    assert keep.shape == model.keep_mask_shape(b)
    assert keep.shape == ((6, b, 512) if name == "vision" else (b, 512))
    assert torch.equal(eps, p_eps) and torch.equal(keep, p_keep)


def test_keep_spec_counts_the_encoders_with_a_dropout():
    assert inputs.keep_spec(config("celeba")) == (1, 512, 0.1)
    assert inputs.keep_spec(config("celeba19")) == (1, 512, 0.1)
    assert inputs.keep_spec(vision_config()) == (6, 512, 0.1)
    cfg = vision_config()
    cfg["stacks"]["gray_encoder.classifier"][2] = ["dropout", 0.2]
    with pytest.raises(ValueError, match="dropouts differ"):
        inputs.keep_spec(cfg)


def test_reference_gives_each_encoder_its_keep_row():
    """The reference's encoder e reads row e of a (6, B, width) keep-mask:
    an encoder's posterior moves with its own row alone."""
    from reference import common
    from reference.celeba import Model
    cfg = vision_config()
    cpu = torch.device("cpu")
    fam, params = Model(cfg), inputs.make_weights(cfg, 2, cpu)
    x = cell_train.as_float(cfg, inputs.make_rows(cfg, 3, 2, cpu))
    keep = torch.rand((6, 3, 512), generator=torch.Generator()
                      .manual_seed(1)) < 0.9
    mu, _ = fam.encode(params, common.Ops(), x, keep, common.BNState(),
                       [2] * 6)
    flipped = keep.clone()
    flipped[4] = ~flipped[4]
    mu2, _ = fam.encode(params, common.Ops(), x, flipped, common.BNState(),
                        [2] * 6)
    moved = [not torch.equal(a, b) for a, b in zip(mu, mu2)]
    assert moved == [False] * 4 + [True, False]


def test_recon_masks_set_the_weights_and_the_support():
    cfg = vision_config()
    terms = inputs.Terms(cfg, 5)
    assert terms.recon_masks.shape == (7, 6)
    masks, lambdas = terms.step()
    np.testing.assert_array_equal(terms.recon_weights(masks, lambdas),
                                  np.full((7, 6), 1 / 6, np.float32))
    np.testing.assert_array_equal(terms.support(), np.ones((7, 6)))
    del cfg["terms"]["recon_masks"]
    terms = inputs.Terms(cfg, 5)
    assert terms.recon_masks is None
    np.testing.assert_array_equal(terms.support(),
                                  np.asarray(cfg["terms"]["masks"]))


def refused(kind):
    if kind == "sampled":
        cfg = config("celeba19")
        cfg["terms"]["recon_masks"] = cfg["terms"]["masks"]
        return cfg, "sampled"
    cfg = config("celeba")
    cfg["terms"]["recon_masks"] = [[1, 1], [1, 1]]
    return cfg, "shape"


@pytest.mark.parametrize("kind", ["sampled", "shape"])
def test_recon_masks_refused(kind):
    cfg, why = refused(kind)
    with pytest.raises(ValueError, match=f"terms.recon_masks.*{why}"):
        inputs.Terms(cfg, 1)


@pytest.mark.parametrize("kind", ["sampled", "shape"])
def test_a_refused_configuration_fails_before_any_timing(checkout, kind):
    cfg, _ = refused(kind)
    add_cell(checkout, "refused", cfg,
             {"loop": "train", "batch": 3, "steps_per_window": 1,
              "rows": 12}, {"loss_gap": 1.0})
    rc, line, err = run_cell(checkout, "refused")
    assert rc != 0 and line is None
    assert "terms.recon_masks" in err
    assert "model built" not in err
