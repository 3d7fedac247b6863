"""Tensor and expert parallelism of the port on the CPU at dp1 x tp2: two
gloo ranks (mvae_tpu_torch/tools/dp_check.py:spawn_ranks) over global
batches of 3 rows (gcd(2, 3) = 1: the leftover factor 2 is the "model"
axis), every family's window of K = 2 train steps against JAX's
single-device make_multi_train_step on the same weights and noise
(tests/_torch_tp_cases.py): MNIST's trailing column layer, FashionMNIST's
`up` pair and text decoder, the DCGAN heads with their dropout's columns
(MultiMNIST, CelebA, celeba19, vision's loop and stack), celeba19's 18
experts 9 a rank; the collectives a step; the tp ops themselves.

The traps this file holds (ROADMAP Queue 3): (d) gather_from_tp's
backward keeps the rank's slice (a sum would double every gradient
upstream of MNIST's trailing column layer, and dx below), (g) a row
layer's partial products are reduced in f32 (bf16 partials, rounded
before the sum, break the bf16 head's single rounding), (h) the dropout's
keep-mask is the global draw's columns (a rank's own draw makes another
step than one device's with the same generator).
"""

import numpy as np
import pytest
import torch

from mvae_tpu_torch.tools import dp_check

from tests import _torch_dp_ranks as ranks
from tests import _torch_tp_cases as C

WORLD, B = 2, 3


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def runs():
    """name -> C.spawn's (the ranks' outcomes, the single process's,
    JAX's); the families and a CelebA window whose noise the step draws,
    one spawn."""
    cases = [C.case(name, B) for name in C.FAMILIES]
    cases.append(C.case("celeba", B, inject=False))
    names = list(C.FAMILIES) + ["celeba-drawn"]
    return dict(zip(names, C.spawn(WORLD, cases)))


@pytest.mark.parametrize("name", list(C.FAMILIES))
def test_tp_step_matches_jax_single_device(runs, name):
    """The ranks' losses are JAX's on the global batches (rtol 1e-5), the
    gradients gathered to full shape are the single process's, and both
    ranks end with JAX's parameters and running statistics after K
    steps (C.check_window)."""
    C.check_window(name, *runs[name], dp_world=1)


# tp collectives a step: the head pair's forward all-reduce and the
# backward all-reduce of its input (the counterpart of JAX's
# test_dcgan_head_compiles_to_one_allreduce); MNIST's three lists; the
# expert gathers and the decoder input's all-reduce; one pair a head
TP_CALLS = {"celeba": 2, "celeba-drawn": 2, "multimnist": 2, "mnist": 11,
            "fashionmnist": 6, "celeba19": 5, "vision": 12,
            "vision-stacked": 4}


@pytest.mark.parametrize("name", sorted(TP_CALLS))
def test_tp_collectives_a_step(runs, name):
    outs = runs[name][0]
    for o in outs:
        assert o["tp_collectives"] == TP_CALLS[name] * C.K
    if name.startswith("celeba-") or name == "celeba":   # 11 BN layers,
        # the sharded gradients on the dp group, the others and the
        # running statistics on the world
        assert outs[0]["all_reduces"] == (2 * 11 + 3) * C.K


def test_drawn_dropout_mask_is_the_global_draws_columns(runs):
    """Trap (h): with the noise drawn by the step (every rank's generator
    seeded alike), each rank's keep-mask is its columns of the global
    draw, so the ranks step as one process with that generator does:
    the losses at rtol 1e-5, step 1's gradients (C.grads_held)."""
    outs, single = runs["celeba-drawn"][:2]
    first = single["windows"][0]["grads"]
    for o in outs:
        for k in range(C.K):
            np.testing.assert_allclose(float(o["windows"][k]["losses"][0]),
                                       float(single["windows"][k]["losses"]
                                             [0]), rtol=1e-5)
        C.grads_held(o["windows"][0]["grads"], first,
                     C.noisy_keys("celeba", first))


@pytest.fixture(scope="module")
def ops():
    rng = np.random.default_rng(4)
    payload = dict(
        x=torch.from_numpy(rng.normal(size=(5, 8)).astype(np.float32)),
        w=torch.from_numpy(rng.normal(size=(5, 8)).astype(np.float32)),
        h=torch.from_numpy(rng.normal(size=(64, 96)).astype(np.float32)),
        head=(96, 16, torch.bfloat16, 9))
    outs = dp_check.spawn_ranks(WORLD, ranks.tp_ops, payload, device="cpu",
                                timeout_s=120)
    return payload, outs


def test_gather_backward_keeps_the_ranks_slice(ops):
    """Trap (d): the forward joins the ranks' features in rank order; the
    backward of sum(y * w) gives a rank w's columns of its slice, once."""
    payload, outs = ops
    for r, o in enumerate(outs):
        torch.testing.assert_close(o["gathered"], payload["x"], rtol=0,
                                   atol=0)
        torch.testing.assert_close(o["dx"], payload["w"].chunk(WORLD, -1)[r],
                                   rtol=0, atol=0)
        assert o["gather_calls"] == 1


def test_bf16_row_layer_reduces_in_f32(ops):
    """Trap (g): a bf16 head at tp 2 (fc column, out row) gives one
    process's output, bit for bit but where the f32 sums' order moves a
    value across a bf16 rounding point (at most 2 % of the 64 x 32
    outputs); partials rounded to bf16 before the sum would move a large
    share of them. One all-reduce, in the forward."""
    payload, outs = ops
    head = ranks.HeadModel(*payload["head"]).eval()
    with torch.no_grad():
        want = head.head(payload["h"])
    for o in outs:
        assert o["head_calls"] == 1
        assert o["head"].dtype == want.dtype == torch.float32
        differ = (o["head"] != want).float().mean().item()
        assert differ <= 0.02, differ
        torch.testing.assert_close(o["head"], want, rtol=1e-2, atol=1e-2)
