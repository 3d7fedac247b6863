"""Tensor and expert parallelism of the port on the CPU at dp2 x tp2: four
gloo ranks over global batches of 6 rows (gcd(4, 6) = 2 dp indices of 3
rows, each a tp group of 2), the families' windows of K = 2 train steps
against JAX's single-device make_multi_train_step (tests/_torch_tp_
cases.py); vision's loop and stack run at dp1 x tp2 only
(tests/test_torch_port_tp_steps.py), for the lane's time.

The traps this file holds (ROADMAP Queue 3): (e) the BN statistics and
their count are the dp group's (over the world, each row would count
twice: Moments.n, the running variance's unbiased factor and the BN
gradients' shares would be off), (f) the noise's rows are the dp
index's (by global rank, ranks 2 and 3 would take rows past the batch).
"""

import numpy as np
import pytest
import torch

from tests import _torch_tp_cases as C

WORLD, B = 4, 6
NAMES = ("mnist", "fashionmnist", "multimnist", "celeba", "celeba19")


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def runs():
    return dict(zip(NAMES, C.spawn(WORLD, [C.case(n, B) for n in NAMES])))


@pytest.mark.parametrize("name", NAMES)
def test_grid_step_matches_jax_single_device(runs, name):
    """The mean of the two dp indices' losses is JAX's on the global
    batches (rtol 1e-5), every rank's gathered gradients are the single
    process's, and all four ranks end with JAX's state (C.check_window)."""
    C.check_window(name, *runs[name], dp_world=2)


def test_tp_ranks_of_a_dp_index_see_its_rows(runs):
    """Trap (f): the two tp ranks of a dp index report the same loss, its
    rows' (not the other index's), and the two indices' differ."""
    outs = runs["celeba"][0]
    for k in range(C.K):
        losses = [float(o["windows"][k]["losses"][0]) for o in outs]
        assert losses[0] == losses[1] and losses[2] == losses[3]
        assert not np.isclose(losses[0], losses[2], rtol=1e-3)


def test_bn_statistics_are_the_dp_groups(runs):
    """Trap (e): CelebA's 11 BN layers reduce over the dp group, one
    all-reduce a pass (and two for the gradients, the sharded ones' on the
    dp group and the others' on the world, and one on the world for the
    running statistics), and the running statistics every rank commits
    are one process's on the whole batch (their unbiased variance counts
    the 6 rows once)."""
    outs, single, _ = runs["celeba"]
    for o in outs:
        assert o["all_reduces"] == (2 * 11 + 3) * C.K
        assert o["tp_collectives"] == 2 * C.K
        for k, v in single["windows"][0]["running"].items():
            got = o["windows"][0]["running"][k]
            assert float((got - v).norm()) <= 1e-5 * float(v.norm()), k
