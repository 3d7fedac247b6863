"""Vision's stacked modality groups in the port (models/vision.py:
VisionMVAE(stack_modalities=True), nn/dcgan.py:stacked, stacked_head,
nn/norm.py:stacked_bn): each channel group runs as one grouped stack.

The stacked form is held against the port's loop (f32 at rtol 1e-5: the
train step's loss and terms, every parameter gradient, every EMA commit,
the eval encode, decode and infer; bf16 at the card's kernel-vs-plain
tolerances, chip_smoke.py's STEP_RTOL and GRAD_RTOL) and against the JAX
package's stacked path (MVAE_STACK_MODALITIES=1) on transplanted weights
with JAX's keep-masks and noise, rtol 1e-4 on the whole ELBO.
"""

import contextlib
import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mvae_tpu_torch.data.vision as vision_data
import mvae_tpu_torch.experiments.vision.train as v_train
from mvae_tpu.core.engine import multi_term_elbo as jax_multi_term_elbo
from mvae_tpu.train.loop import decode_batch as jax_decode_batch
from mvae_tpu_torch.core.engine import multi_term_elbo
from mvae_tpu_torch.data.celeba import synthetic_celeba
from mvae_tpu_torch.models import VisionMVAE
from mvae_tpu_torch.models.vision import CHANNELS, GROUPS, MODALITIES
from mvae_tpu_torch.train.loop import decode_batch
from mvae_tpu_torch.utils.weights import state_dict_from_jax
from tests.test_torch_port_vision import (
    L, _jax, _torch, jax_model, jax_noise, port_model, vision_batch)

B = 2
TERM_MASKS, RECON_MASKS = v_train.TERM_MASKS, v_train.RECON_MASKS
TERM_LAMBDAS = v_train.TERM_LAMBDAS
# the stacked form against the loop: f32 apart only by the grouped
# convolutions' order of summation
F32 = dict(rtol=1e-5, atol=1e-6)
GRAD_F32 = 1e-5               # relative Frobenius norm, each parameter
# bf16: a last-bit change before a bf16 rounding flips it (chip_smoke.py:
# STEP_RTOL and GRAD_RTOL of the kernel path against its plain versions)
LOSS_BF16, GRAD_BF16 = 1e-3, 5e-2


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """The port's side on one intra-op thread, restored after (see
    tests/test_torch_port_families.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def rel(a, b):
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


@pytest.fixture(scope="module")
def weights():
    _, params, state = jax_model(seed=1)
    return params, state


def test_groups_cover_each_modality_once_with_one_channel_count():
    assert sorted(m for g in GROUPS for m in g) == sorted(MODALITIES)
    for g in GROUPS:
        assert len({CHANNELS[m] for m in g}) == 1


def test_stacked_state_dict_is_the_loops(weights):
    loop = port_model(*weights)
    stacked = port_model(*weights, stack_modalities=True)
    a, b = loop.state_dict(), stacked.state_dict()
    assert list(a) == list(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    fresh = VisionMVAE(L, device="cpu", stack_modalities=True)
    fresh.load_state_dict(a, strict=True)
    assert [k for k, _ in fresh.named_parameters()] == [
        k for k, _ in loop.named_parameters()]


def test_stacked_refuses_the_fused_route():
    with pytest.raises(ValueError, match="conv2d_moments has no groups"):
        VisionMVAE(L, device="cpu", stack_modalities=True,
                   conv_moments=True)


def _step(pm, batch_u8, noise):
    pm.train()
    pm.zero_grad(set_to_none=True)
    total, aux = multi_term_elbo(
        pm, decode_batch(_torch(batch_u8)), torch.tensor(TERM_MASKS),
        torch.tensor(TERM_LAMBDAS), 0.7, train=True,
        noise=tuple(torch.from_numpy(a.copy()) for a in noise),
        recon_masks=torch.tensor(RECON_MASKS))
    total.backward()
    return dict(total=total.detach(), per_term=aux["per_term"].detach(),
                grads={k: p.grad.clone() for k, p in pm.named_parameters()},
                state={k: v.clone() for k, v in pm.state_dict().items()
                       if k.endswith(("running_mean", "running_var"))})


@pytest.fixture(scope="module")
def steps(weights):
    """The T = 7 train step with RECON_MASKS on JAX's weights, batch and
    noise: the port's loop, the port's stacked form, and JAX's stacked
    path (MVAE_STACK_MODALITIES=1: one vmapped stack a group)."""
    params, state = weights
    batch_u8 = vision_batch(B, 31, uint8=True)
    key = jax.random.key(7)
    noise = jax_noise(key, 7, B)
    out = {name: _step(port_model(params, state, stack_modalities=flag),
                       batch_u8, noise)
           for name, flag in (("loop", False), ("stacked", True))}
    jm = jax_model(seed=1)[0]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MVAE_STACK_MODALITIES", "1")

        def loss(p):
            total, aux, new_state = jax_multi_term_elbo(
                jm, p, state, jax_decode_batch(_jax(batch_u8), jnp.float32),
                jnp.asarray(TERM_MASKS), jnp.asarray(TERM_LAMBDAS), key, 0.7,
                train=True, recon_masks=jnp.asarray(RECON_MASKS))
            return total, (aux["per_term"], new_state)

        (total, (per_term, new_state)), grads = jax.jit(jax.value_and_grad(
            loss, has_aux=True))(params)
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    out["jax"] = dict(
        total=float(total), per_term=np.asarray(per_term),
        grads=state_dict_from_jax("vision", np_tree(grads), state),
        state=state_dict_from_jax("vision", params, np_tree(new_state)))
    return out


def test_stacked_train_step_equals_the_loop(steps):
    """Loss and the 7 terms at rtol 1e-5; every parameter's gradient
    within 1e-5 of the loop's in relative Frobenius norm."""
    loop, st = steps["loop"], steps["stacked"]
    torch.testing.assert_close(st["total"], loop["total"], **F32)
    torch.testing.assert_close(st["per_term"], loop["per_term"], **F32)
    assert list(st["grads"]) == list(loop["grads"])
    for k, g in loop["grads"].items():
        assert rel(st["grads"][k], g) < GRAD_F32, (k, rel(st["grads"][k], g))


def test_stacked_ema_commits_equal_the_loop(steps):
    """Each of the 72 running statistics after the step: the encoders'
    two commits and the decoders' seven, from the moments the stacked
    BNs split back to each module."""
    loop, st = steps["loop"], steps["stacked"]
    assert len(loop["state"]) == 6 * 12
    for k, v in loop["state"].items():
        torch.testing.assert_close(st["state"][k], v, **F32, msg=k)


def test_stacked_step_equals_jax_stacked(steps):
    """The port's stacked step against JAX's stacked path: the ELBO and
    its terms at rtol 1e-4, gradients within 5e-5 and the committed
    state at rtol 1e-5, as the loop is held to JAX's loop
    (tests/test_torch_port_vision.py)."""
    st, jx = steps["stacked"], steps["jax"]
    np.testing.assert_allclose(float(st["total"]), jx["total"], rtol=1e-4)
    np.testing.assert_allclose(st["per_term"].numpy(), jx["per_term"],
                               rtol=1e-4)
    for k, g in st["grads"].items():
        want = jx["grads"][k]
        gap = np.linalg.norm(g.numpy() - want)
        assert gap < 5e-5 * np.linalg.norm(want), (k, gap)
    for k, v in st["state"].items():
        np.testing.assert_allclose(v.numpy(), jx["state"][k], rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def test_stacked_eval_equals_the_loop(weights):
    """Eval mode (running statistics, no dropout): the six posteriors,
    the six decoders' f32 logits and infer on subsets, at rtol 1e-5."""
    loop = port_model(*weights)
    st = port_model(*weights, stack_modalities=True)
    batch = _torch(vision_batch(3, 4))
    z = torch.from_numpy(
        np.random.default_rng(2).normal(size=(5, L)).astype(np.float32))
    with torch.no_grad():
        a, b = loop.encode(batch), st.encode(batch)
        assert b[2] == {m: [] for m in MODALITIES}
        for x, y in zip(a[:2], b[:2]):
            torch.testing.assert_close(y, x, **F32)
        ra, rb = loop.decode(z)[0], st.decode(z)[0]
        assert list(ra) == list(rb) == list(MODALITIES)
        for m in MODALITIES:
            assert rb[m].dtype == torch.float32 and rb[m].shape == ra[m].shape
            # the losses' kernel on the card takes contiguous rows
            assert rb[m].reshape(5, -1).is_contiguous(), m
            torch.testing.assert_close(rb[m], ra[m], **F32, msg=m)
        for names in (("edge",), ("gray", "watermark"), MODALITIES):
            sub = {k: batch[k] for k in names}
            for x, y in zip(loop.infer(sub), st.infer(sub)):
                torch.testing.assert_close(y, x, **F32)


def test_stacked_bf16_step_close_to_the_loop(weights):
    """bf16 compute: the loss at rtol LOSS_BF16, every nonzero gradient
    within GRAD_BF16 of the loop's in relative norm."""
    params, state = weights
    batch_u8 = vision_batch(B, 32, uint8=True)
    noise = jax_noise(jax.random.key(9), 7, B)
    out = [_step(port_model(params, state, torch.bfloat16,
                            stack_modalities=flag), batch_u8, noise)
           for flag in (False, True)]
    loop, st = out
    assert torch.isfinite(st["total"])
    torch.testing.assert_close(st["total"], loop["total"], rtol=LOSS_BF16,
                               atol=0.0)
    for k, g in loop["grads"].items():
        if float(g.norm()) > 0:
            assert rel(st["grads"][k], g) < GRAD_BF16, k


def _cli(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        v_train.main(argv)
    return [float(ln.split()[-1]) for ln in buf.getvalue().splitlines()
            if ln.startswith("====> Test Loss")]


def test_train_cli_stack_modalities(tmp_path, monkeypatch):
    """The train CLI's --stack-modalities on 20 / 10 synthetic rows, one
    epoch: its test loss equals the loop's at rtol 1e-5 (f32, one seed);
    with --conv-moments it refuses before it loads the data."""
    sets = {"train": synthetic_celeba(20, seed=0),
            "val": synthetic_celeba(10, seed=1)}
    loads = []
    monkeypatch.setattr(vision_data, "load_celeba", lambda data_dir, part,
                        **kw: loads.append(part) or sets[part])
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32",
                        torch.backends.cudnn.allow_tf32)
    flags = ["--device", "cpu", "--n-latents", str(L), "--batch-size", "5",
             "--log-interval", "2", "--annealing-epochs", "1", "--seed",
             "3", "--f32", "--epochs", "1", "--data-dir", str(tmp_path)]
    tests = [_cli(flags + ["--out-dir", str(tmp_path / name)] + extra)
             for name, extra in (("loop", []),
                                 ("stacked", ["--stack-modalities"]))]
    assert len(tests[1]) == 1 and np.isfinite(tests[1][0])
    np.testing.assert_allclose(tests[1], tests[0], rtol=1e-5)
    assert os.path.isfile(tmp_path / "stacked" / "model_best.pth.tar")
    loads.clear()
    with pytest.raises(ValueError, match="conv2d_moments"):
        v_train.main(flags + ["--out-dir", str(tmp_path / "x"),
                              "--stack-modalities", "--conv-moments"])
    assert loads == []
