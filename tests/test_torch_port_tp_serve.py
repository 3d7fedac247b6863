"""Serving over a data-parallel group (serve.py:Sampler(dp=)) on the CPU:
two spawned gloo ranks each serve a CelebA checkpoint and call every
endpoint (mvae_tpu_torch/tools/dp_check.py:serve_endpoints), against one
device's Sampler; the buckets round up to a multiple of the group's size,
so 5 rows run as 8 (4 a rank) and 3 as 4."""

import numpy as np
import pytest
import torch

from mvae_tpu_torch.models import CelebaMVAE
from mvae_tpu_torch.serve import Sampler
from mvae_tpu_torch.tools import dp_check

from tests.test_torch_port_modules import celeba_batch

CONDITIONS = (("image",), ("attrs",), ("image", "attrs"))


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_sampler_over_two_ranks_is_one_devices(tmp_path):
    """Every endpoint, conditioned on each modality set: both ranks return
    one device's values (f32 at 1e-5: the rows' matmuls taken in two
    parts), of the requested rows."""
    path = str(tmp_path / "model_best.pth.tar")
    model = CelebaMVAE(8, device="cpu",
                       generator=torch.Generator().manual_seed(4))
    torch.save({"state_dict": model.state_dict(), "n_latents": 8,
                "model": "celeba"}, path)
    inputs = {k: torch.from_numpy(v)
              for k, v in celeba_batch(5, 6).items()}
    payload = dict(path=path, dtype=None, inputs=inputs,
                   conditions=CONDITIONS)
    outs = dp_check.spawn_ranks(2, dp_check.serve_endpoints, payload,
                                device="cpu", timeout_s=120)
    want = dp_check.endpoint_outputs(Sampler(model, device="cpu"), inputs,
                                     CONDITIONS)
    assert want["sample image"].shape[0] == 5
    assert want["embed|image mu"].shape == (5, 8)
    for o in outs:
        assert set(o) == set(want)
        for k, v in want.items():
            np.testing.assert_allclose(o[k].numpy(), v.numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=k)
