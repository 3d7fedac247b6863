"""A run with the timed path broken underneath comes out not correct:
each fault a cell can have, planted in the port, on the CPU at a tiny
size against the cells' own limits (the look for a card skipped)."""

import pytest

from conftest import run_cell

STATE_UNCHANGED = (
    "import torch\n"
    "torch.optim.Adam.step = lambda self, closure=None: None")
HALF_BATCH = (
    "from mvae_tpu_torch.train import loop\n"
    "_gather = loop._gather\n"
    "def half(batch, device_data):\n"
    "    data, idx = batch\n"
    "    return _gather((data, idx[:idx.shape[0] // 2]), device_data)\n"
    "loop._gather = half")
ANSWER_ALTERED = (
    "from mvae_tpu_torch.core import loglike\n"
    "_iwae = loglike.iwae_log_marginal\n"
    "def altered(*a, **kw):\n"
    "    out = _iwae(*a, **kw).clone()\n"
    "    out[0] = out[0] * 1.01\n"
    "    return out\n"
    "loglike.iwae_log_marginal = altered")


@pytest.mark.parametrize("workload,fault", [
    ("celeba.train.b4096", STATE_UNCHANGED),
    ("celeba.train.b4096", HALF_BATCH),
    ("celeba19.train.b2048", STATE_UNCHANGED),
    ("celeba19.train.b2048", HALF_BATCH),
    ("celeba.score.k100", ANSWER_ALTERED),
])
def test_fault_is_not_correct(checkout, workload, fault):
    rc, line, err = run_cell(checkout, workload, patch=fault)
    assert rc == 0, err[-3000:]
    assert line["correct"] is False, line["checks"]
