"""The port's CUDA kernels and paths on the card. Every test here needs an
NVIDIA GPU (marker `cuda`) and skips without one. The file imports nothing
of JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py -q
"""

import numpy as np
import pytest
import torch

from mvae_tpu_torch import ops
from mvae_tpu_torch.models.celeba import CelebaMVAE
from mvae_tpu_torch.ops.elbo import bce_rowsum_plain
from mvae_tpu_torch.ops.poe import poe_plain
from mvae_tpu_torch.serve import Sampler
from mvae_tpu_torch.train.loop import make_eval_step

pytestmark = pytest.mark.cuda

MASKS = [[1.0, 1.0], [1.0, 0.0], [0.0, 1.0]]
LAMBDAS = [[1.0, 10.0]] * 3
# kernel vs plain version, both f32: sums taken in another order
POE_TOL = dict(rtol=1e-5, atol=1e-6)
BCE_TOL = dict(rtol=1e-5, atol=1e-4)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("t,m,b", [(1, 2, 1), (1, 2, 64), (3, 2, 100),
                                   (5, 19, 7)])
def test_poe_kernel_matches_plain(cuda, t, m, b):
    g = torch.Generator(device=cuda).manual_seed(t * 10 + m)
    mu = torch.randn((m, b, 100), generator=g, device=cuda)
    lv = torch.randn((m, b, 100), generator=g, device=cuda)
    masks = (torch.rand((t, m), generator=g, device=cuda) < 0.6).float()
    n = ops.poe_fwd.launches
    k_mu, k_lv = ops.masked_poe_all_terms(mu, lv, masks)
    torch.cuda.synchronize()
    assert ops.poe_fwd.launches == n + 1
    p_mu, p_lv = poe_plain(mu, lv, masks)
    torch.testing.assert_close(k_mu, p_mu, **POE_TOL)
    torch.testing.assert_close(k_lv, p_lv, **POE_TOL)


@pytest.mark.parametrize("n,nt,k,x_dt,t_dt", [
    (300, 300, 12288, torch.float32, torch.float32),
    (300, 300, 12288, torch.float32, torch.bfloat16),
    (300, 100, 12288, torch.float32, torch.bfloat16),   # shared targets
    (300, 100, 18, torch.float32, torch.float32),       # unaligned rows
    (8, 8, 12288, torch.bfloat16, torch.bfloat16),
    (8, 4, 12290, torch.bfloat16, torch.float32),       # scalar path
])
def test_bce_kernel_matches_plain(cuda, n, nt, k, x_dt, t_dt):
    g = torch.Generator(device=cuda).manual_seed(3)
    x = (3 * torch.randn((n, k), generator=g, device=cuda)).to(x_dt)
    t = torch.rand((nt, k), generator=g, device=cuda).to(t_dt)
    got = ops.bce_sum(x, t)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, bce_rowsum_plain(x, t), **BCE_TOL)


def test_kernel_wrappers_reject_what_they_do_not_take(cuda):
    x = torch.zeros((4, 8), device=cuda)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ops.bce_rowsum_fwd(x.half(), x)
    with pytest.raises(ValueError, match="contiguous"):
        ops.bce_rowsum_fwd(torch.zeros((8, 4), device=cuda).t(), x)
    with pytest.raises(ValueError, match="experts"):
        m = torch.zeros((33, 2, 3), device=cuda)
        ops.poe_fwd(m, m, torch.ones((1, 33), device=cuda))


def _batch(cuda, b=4):
    rng = np.random.default_rng(0)
    return {"image": torch.from_numpy(rng.integers(
                0, 256, (b, 64, 64, 3), dtype=np.uint8)).to(cuda),
            "attrs": torch.from_numpy((rng.random((b, 18)) < 0.3)
                                      .astype(np.float32)).to(cuda)}


def test_eval_step_goes_through_the_kernels(cuda):
    """One PoE launch and two BCE launches per eval step; the result equals
    the same step on the plain versions (f32, TF32 off) at rtol 1e-4 and
    the same step on the CPU at rtol 1e-4."""
    model = CelebaMVAE(8, device=cuda)
    batch = _batch(cuda)
    step = make_eval_step(model, MASKS, LAMBDAS)
    ops.reset_launch_counts()
    total, per_term = step(batch)
    assert ops.launch_counts() == {"poe_fwd": 1, "bce_rowsum_fwd": 2}
    with ops.plain_versions():
        p_total, p_terms = step(batch)
    assert ops.launch_counts() == {"poe_fwd": 1, "bce_rowsum_fwd": 2}
    torch.testing.assert_close(per_term, p_terms, rtol=1e-4, atol=0)
    torch.testing.assert_close(total, p_total, rtol=1e-4, atol=0)
    cpu = CelebaMVAE(8, device="cpu")
    c_total, c_terms = make_eval_step(cpu, MASKS, LAMBDAS, device="cpu")(
        {k: v.cpu() for k, v in batch.items()})
    torch.testing.assert_close(per_term.cpu(), c_terms, rtol=1e-4, atol=0)


def test_embed_is_one_poe_launch(cuda):
    sampler = Sampler(CelebaMVAE(8, device=cuda))
    ops.reset_launch_counts()
    mu, _ = sampler.embed({"attrs": np.zeros((3, 18), np.float32)})
    assert mu.shape == (3, 8) and mu.is_cuda
    assert ops.launch_counts() == {"poe_fwd": 1, "bce_rowsum_fwd": 0}
