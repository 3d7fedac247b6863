"""The placement rule of the port's "model" axis (mvae_tpu_torch/parallel/
mesh.py:tp_plan) against the JAX package's tp_spec_tree, and the Megatron
pairing on the port's modules.

JAX's specs are mapped to the port's keys through the weight exporter
itself (utils/weights.py:state_dict_from_jax): one export of the JAX tree
with each leaf filled with its own number tells which port tensors a leaf
becomes; one export with each leaf filled with its index along JAX axis a
tells, for a leaf sharded on a, the port dim that index runs along (the
transposed one of a linear's weight); a stacked expert leaf unstacks into
tensors along none, the expert axis.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from mvae_tpu.models.celeba import CelebaMVAE as JaxCeleba
from mvae_tpu.models.celeba19 import Celeba19MVAE as JaxCeleba19
from mvae_tpu.models.fashionmnist import FashionMnistMVAE as JaxFashion
from mvae_tpu.models.mnist import MnistMVAE as JaxMnist
from mvae_tpu.models.multimnist import MultiMnistMVAE as JaxMultiMnist
from mvae_tpu.models.vision import VisionMVAE as JaxVision
from mvae_tpu.parallel.mesh import tp_spec_tree

from mvae_tpu_torch.models import (
    Celeba19MVAE, CelebaMVAE, FashionMnistMVAE, MnistMVAE, MultiMnistMVAE,
    VisionMVAE)
from mvae_tpu_torch.nn.layers import mlp
from mvae_tpu_torch.parallel import mesh
from mvae_tpu_torch.utils.weights import state_dict_from_jax

L = 8
FAMILIES = {"mnist": (JaxMnist, MnistMVAE),
            "fashionmnist": (JaxFashion, FashionMnistMVAE),
            "multimnist": (JaxMultiMnist, MultiMnistMVAE),
            "celeba": (JaxCeleba, CelebaMVAE),
            "celeba19": (JaxCeleba19, Celeba19MVAE),
            "vision": (JaxVision, VisionMVAE)}
TPS = (2, 3, 4, 8)


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def _filled(tree, fill):
    """The tree's leaves replaced by fill(i, shape) as f32 numpy."""
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    return jax.tree_util.tree_unflatten(treedef, [
        np.asarray(fill(i, leaf.shape), np.float32)
        for i, leaf in enumerate(leaves)])


def _index_along(axis):
    def fill(i, shape):
        if len(shape) <= axis:
            return np.zeros(shape)
        idx = np.arange(shape[axis]).reshape(
            (-1,) + (1,) * (len(shape) - axis - 1))
        return np.broadcast_to(idx + 1.0, shape)
    return fill


def _runs_along(t):
    """The dims along which t's values change."""
    return [d for d in range(t.ndim)
            if t.shape[d] > 1 and not np.all(np.diff(t, axis=d) == 0)]


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def family(request):
    """(family, the JAX (params, state) shapes, leaf number -> the port
    keys it exports to, axis -> the export of each leaf's index along it,
    the port model)."""
    name = request.param
    jcls, pcls = FAMILIES[name]
    params, state = jax.eval_shape(lambda: jcls(L).init(jax.random.key(0)))
    owners = {}
    sd = state_dict_from_jax(name, *_filled(
        (params, state), lambda i, shape: np.full(shape, i + 1.0)))
    for k, v in sd.items():
        if k.endswith("num_batches_tracked"):
            continue
        owners.setdefault(int(v.flat[0]) - 1, []).append(k)
    along = {a: state_dict_from_jax(name, *_filled((params, state),
                                                   _index_along(a)))
             for a in (0, 1)}
    model = pcls(L, device="cpu")
    return name, params, owners, along, model


def _jax_plan(params, owners, along, tp):
    """tp_spec_tree(params, tp) read through the exporter: port key ->
    the sharded dim, mesh.EXPERT or None."""
    specs = jax.tree_util.tree_leaves(
        tp_spec_tree(params, tp), is_leaf=lambda s: isinstance(s, P))
    plan = {}
    for i, ((path, _), spec) in enumerate(zip(_leaves(params), specs)):
        axes = [a for a, s in enumerate(spec) if s == "model"]
        for k in owners[i]:
            if not axes:
                plan[k] = None
                continue
            dims = _runs_along(along[axes[0]][k])
            assert len(dims) <= 1, (k, dims)
            plan[k] = dims[0] if dims else mesh.EXPERT
    return plan


@pytest.mark.parametrize("tp", TPS)
def test_plan_equals_jax_tp_spec_tree(family, tp):
    """For every parameter, the port's plan shards the dim (or the expert
    axis) that JAX's tp_spec_tree shards, mapped through the exporter, and
    replicates what JAX replicates."""
    name, params, owners, along, model = family
    got = {n: s.dim if isinstance(s, mesh.Shard) else s
           for n, s in mesh.tp_plan(model, tp).items()}
    want = _jax_plan(params, owners, along, tp)
    assert set(got) == set(want)
    assert got == want
    if name == "celeba19":      # the 13 expert leaves where 18 % tp == 0,
        for part, n in (("attr_", 13 if 18 % tp == 0 else 0),   # the
                        ("image_", 3 if 512 % tp == 0 else 0)):  # head's 3
            assert len({i for i, ks in owners.items() if any(
                k.startswith(part) and want.get(k) is not None
                for k in ks)}) == n


def test_mnist_joint_head_splits_as_jax():
    """MNIST's 2L head is fc31 | fc32 on the port, one JAX linear whose 2L
    columns split: at tp 2 into [mu] and [logvar], at tp 3 (L = 3) into
    [mu 0:2], [mu 2, logvar 0] and [logvar 1:3]; a rank's slices of the
    two, joined, are JAX's column block. 2L = 6 does not divide by 4."""
    model = MnistMVAE(3, device="cpu")          # 2L = 6: tp 2 and 3 shard
    for tp in (2, 3):
        plan = mesh.tp_plan(model, tp)
        spec = plan["image_encoder.fc31.weight"]
        assert spec == mesh.Shard(0, 0, 6)
        assert plan["image_encoder.fc32.bias"] == mesh.Shard(0, 3, 6)
        w = torch.cat([model.image_encoder.fc31.weight,
                       model.image_encoder.fc32.weight])
        for r in range(tp):
            parts = [w[:3].narrow(0, *_len(mesh._span(spec, 3, r, tp))),
                     w[3:].narrow(0, *_len(mesh._span(
                         plan["image_encoder.fc32.weight"], 3, r, tp)))]
            torch.testing.assert_close(torch.cat(parts),
                                       w.chunk(tp)[r], rtol=0, atol=0)
    assert mesh.tp_plan(model, 4)["image_encoder.fc31.weight"] is None


def _len(span):
    lo, hi = span
    return lo, hi - lo


class _Chain(torch.nn.Module):
    """One MLP list as a model with a single tp chain."""
    tp_experts = ()

    def __init__(self, dims):
        super().__init__()
        self.net = mlp(dims, device="cpu")

    def tp_chains(self):
        return [[(f"net.{2 * i}",) for i in range(len(self.net) // 2 + 1)]]


def _weight_dims(dims, tp):
    plan = mesh.tp_plan(_Chain(dims), tp)
    return [(plan[f"net.{2 * i}.weight"], plan[f"net.{2 * i}.bias"])
            for i in range(len(dims) - 1)]


def test_mlp_pairs_alternate_col_row():
    """tests/test_tp_megatron.py:28-36 on the port's mlp: column layers
    shard weight dim 0 and the bias, row layers weight dim 1 and keep the
    bias whole."""
    col = (mesh.Shard(0, 0, 512), mesh.Shard(0, 0, 512))
    row = (mesh.Shard(1), None)
    assert _weight_dims([784, 512, 512, 512, 784], 8) == [col, row, col, row]


def test_ragged_axis_replicates_and_restarts():
    """tests/test_tp_megatron.py:39-49: a 10-wide layer replicates at tp 8
    and the pairing restarts at column; nothing divides by 3."""
    got = [w for w, _ in _weight_dims([64, 512, 10, 512, 512], 8)]
    assert got == [mesh.Shard(0, 0, 512), mesh.Shard(1),
                   mesh.Shard(0, 0, 512), mesh.Shard(1)]
    got = _weight_dims([64, 512, 10, 512, 512], 3)
    assert all(w is None and b is None for w, b in got)
    # a 10-wide output cannot start a pair at tp 4: replicate, restart
    got = [w for w, _ in _weight_dims([64, 10, 512, 512], 4)]
    assert got == [None, mesh.Shard(0, 0, 512), mesh.Shard(1)]


@pytest.mark.parametrize("world,batch,grid", [
    (8, 100, (4, 2)), (3, 100, (1, 3)), (4, 6, (2, 2)), (2, 5, (1, 2)),
    (4, 100, (4, 1)), (1, 7, (1, 1))])
def test_grid_is_the_jax_mesh_policy(world, batch, grid):
    """n_dp = gcd(N, B), n_tp = N / n_dp (mvae_tpu/train/driver.py:96-103);
    a model axis across nodes is refused, within one node it is not."""
    assert mesh.grid(world, batch) == grid
    mesh.check_batch(batch, world)
    if grid[1] > 1:
        with pytest.raises(SystemExit, match="multi-node runs ship "
                                             "data-parallel only"):
            mesh.check_batch(batch, world, local_world=world - 1)
    else:
        mesh.check_batch(batch, world, local_world=1)
