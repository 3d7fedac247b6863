"""The ranks as a (data, model) grid, and the placement of parameters over
its "model" axis (counterpart of mvae_tpu/parallel/mesh.py and of the
mesh policy in mvae_tpu/train/driver.py:89-143).

The JAX package puts every device into its mesh: the batch axis shards
over gcd(devices, batch) of them, and the leftover factor becomes a
"model" axis of tensor and expert parallelism. The port runs one process
a device: N ranks and a batch of B rows give n_dp = gcd(N, B) and n_tp =
N / n_dp, and rank r sits at (r // n_tp, r % n_tp), as JAX reshapes its
devices into (data, model). The ranks of one tp index form a dp group,
each holding B / n_dp rows of every batch; the ranks of one dp index form
a tp group, which holds the same rows and splits the parameters that the
placement rule shards. `DataParallel` names both groups; `dp.rank` and
`dp.world` are the dp index and size wherever they are read.

The placement rule (`tp_plan`) is JAX's tp_spec_tree over the port's
modules (the model's tp_chains and tp_experts, models/base.py), for the
reasons in its docstring (mvae_tpu/parallel/mesh.py:80-151):

  * Megatron pairing of an MLP list: a layer is column-parallel where its
    output features divide by tp, the next row-parallel where its input
    features do; a ragged layer replicates and restarts the pairing at
    "column". A DCGAN head's {fc, out} pair pairs the same way.
  * The experts (celeba19's stacked attribute nets) shard on their
    leading axis where it divides by tp: a rank keeps its experts.
  * Everything else replicates: conv kernels, BN scales and biases,
    embeddings, lone linears, the decoders' lone `up`, CelebA's attribute
    MLP (its layers are {fc, bn} blocks, not lists of linears).

JAX's `w` is (in, out) and torch's `weight` (out, in), so a column layer
shards its weight's dim 0 and its bias; a row layer its weight's dim 1,
its bias replicated. A spec is `Shard(dim, offset, total)`: the rank's
part of a dim of `total` features split tp ways, of which this parameter
holds [offset, offset + its size) (MNIST's fc31 and fc32 are the halves
of one JAX linear whose 2L outputs split; for any other parameter offset
0, total its size), or EXPERT, or None (replicated).

`shard_params_tp` leaves each module its rank's slice and gives each
Linear its TPRole (nn/layers.py); `gather_full` and `local_from_full`
carry a name -> tensor dict (a state_dict, Adam's moments) between the
reference layout and a rank's slices, for the checkpoints.

`check_batch` refuses a run whose tp ranks would span nodes: the JAX
package refuses tensor parallelism across hosts, and the port's ranks on
one node are the counterpart of one JAX process's local devices.
"""

import math
from typing import NamedTuple

import torch
import torch.distributed as dist

from mvae_tpu_torch.nn.layers import TPRole
from mvae_tpu_torch.parallel.tensor_parallel import all_gather

EXPERT = "expert"


class DataParallel(NamedTuple):
    """A rank's place in the grid: its dp group (the ranks of its tp
    index, each with `world`-th of a batch), its dp index and size, and
    its tp group, tp index and size (None, 0, 1 without a model axis)."""
    group: object
    rank: int
    world: int
    tp_group: object = None
    tp_rank: int = 0
    tp_world: int = 1


class Shard(NamedTuple):
    dim: int
    offset: int = 0
    total: int = None


def grid(world: int, batch_size: int) -> tuple:
    """(n_dp, n_tp) of `world` ranks over batches of batch_size rows
    (mvae_tpu/train/driver.py:96-103)."""
    n_dp = math.gcd(world, batch_size)
    return n_dp, world // n_dp


def data_parallel(batch_size: int, group=None) -> DataParallel:
    """The grid of the group's ranks (None: the default group) over
    batches of batch_size rows. With a model axis it makes the dp and tp
    groups (dist.new_group): every rank must call it, in the same order
    as the others."""
    group = dist.group.WORLD if group is None else group
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    n_dp, n_tp = grid(world, batch_size)
    if n_tp == 1:
        return DataParallel(group, rank, world)
    ranks = [dist.get_global_rank(group, r) for r in range(world)]
    dp_groups = [dist.new_group([ranks[d * n_tp + t] for d in range(n_dp)])
                 for t in range(n_tp)]
    tp_groups = [dist.new_group([ranks[d * n_tp + t] for t in range(n_tp)])
                 for d in range(n_dp)]
    d, t = divmod(rank, n_tp)
    return DataParallel(dp_groups[t], d, n_dp, tp_groups[d], t, n_tp)


def check_batch(batch_size: int, world: int, local_world: int = None):
    """SystemExit where `world` ranks, local_world of them on this node
    (None: all), would run a model axis (tp > 1) across nodes."""
    _, n_tp = grid(world, batch_size)
    if n_tp > 1 and (local_world or world) < world:
        raise SystemExit(
            f"multi-node runs ship data-parallel only (params stay "
            f"replicated so every host can checkpoint/eval them); pick a "
            f"--batch-size divisible by the {world} global ranks (got "
            f"{batch_size})")


def mesh_line(dp: DataParallel, batch_size: int) -> str:
    """The JAX driver's line for a dp x tp grid."""
    n = dp.world * dp.tp_world
    return (f"mesh over all {n} devices: {dp.world}-way data x "
            f"{dp.tp_world}-way tensor/expert parallel (batch {batch_size} "
            f"is not divisible by {n}; the leftover factor shards "
            f"parameters, not nothing)")


# -- the placement rule ----------------------------------------------------

def _megatron(chain, modules, tp: int) -> list:
    """The kind of each layer of a chain: "col", "row" or None
    (mvae_tpu/parallel/mesh.py:mlp_specs_megatron)."""
    roles, col = [], True
    for layer in chain:
        ws = [modules[n].weight for n in layer]
        out_ax, in_ax = sum(w.shape[0] for w in ws), ws[0].shape[1]
        if col and out_ax % tp == 0:
            roles.append("col")
            col = False
        elif not col and in_ax % tp == 0:
            roles.append("row")
            col = True
        else:
            roles.append(None)
            col = True
    return roles


def tp_plan(model, tp: int) -> dict:
    """{parameter name: Shard, EXPERT or None} of the model at tp ranks."""
    return _placement(model, tp)[0]


def _placement(model, tp: int) -> tuple:
    """(tp_plan, [(a chain layer's module names, its kind, gather)])."""
    modules = dict(model.named_modules())
    plan = {n: None for n, _ in model.named_parameters()}
    roles = []
    for chain in model.tp_chains():
        kinds = _megatron(chain, modules, tp)
        for j, (layer, kind) in enumerate(zip(chain, kinds)):
            roles.append((layer, kind, kind == "col" and j == len(chain) - 1))
            if kind is None:
                continue
            total = sum(modules[n].weight.shape[0] for n in layer)
            offset = 0
            for n in layer:
                size = modules[n].weight.shape[0]
                if kind == "col":
                    plan[f"{n}.weight"] = Shard(0, offset, total)
                    plan[f"{n}.bias"] = Shard(0, offset, total)
                else:
                    plan[f"{n}.weight"] = Shard(1)
                offset += size
    for name in model.tp_experts:
        if len(modules[name]) % tp == 0:
            for n in plan:
                if n.startswith(name + "."):
                    plan[n] = EXPERT
    return plan, roles


def _span(spec: Shard, size: int, rank: int, tp: int) -> tuple:
    """(lo, hi) of the rank's part of a parameter of `size` on spec.dim."""
    total = size if spec.total is None else spec.total
    chunk = total // tp
    lo = min(max(rank * chunk - spec.offset, 0), size)
    hi = min(max((rank + 1) * chunk - spec.offset, 0), size)
    return lo, hi


def _expert_keys(n: int, rank: int, tp: int) -> list:
    """The ModuleDict keys of the rank's experts, of n."""
    k = n // tp
    return [str(i) for i in range(rank * k, (rank + 1) * k)]


class TPLayout(NamedTuple):
    """What shard_params_tp did to a model, for the checkpoints."""
    plan: dict
    shapes: dict            # full name -> full shape, params and buffers
    names: tuple            # the full state_dict's keys, in order
    params: tuple           # the full model's parameter names, in order
    experts: dict           # ModuleDict name -> its experts, all ranks
    rank: int
    world: int
    group: object


@torch.no_grad()
def shard_params_tp(model, dp: DataParallel) -> TPLayout:
    """Leave each of the model's modules its rank's slice under
    tp_plan(model, dp.tp_world), give each chain Linear its TPRole and the
    experts' owner its group; returns the layout (also model.tp_layout).
    The model must hold the full parameters, equal on every rank."""
    tp, rank, group = dp.tp_world, dp.tp_rank, dp.tp_group
    plan, roles = _placement(model, tp)
    sd = model.state_dict()
    layout = TPLayout(
        plan, {n: tuple(v.shape) for n, v in sd.items()}, tuple(sd),
        tuple(n for n, _ in model.named_parameters()),
        {name: len(getattr(model, name)) for name in model.tp_experts
         if any(plan[n] == EXPERT for n in plan
                if n.startswith(name + "."))}, rank, tp, group)
    modules = dict(model.named_modules())
    for name, p in model.named_parameters():
        spec = plan[name]
        if isinstance(spec, Shard):
            lo, hi = _span(spec, p.shape[spec.dim], rank, tp)
            p.data = p.data.narrow(spec.dim, lo, hi - lo).clone()
    for layer, kind, gather in roles:
        for n in layer:
            modules[n].tp = (None if kind is None
                             else TPRole(kind, group, gather))
    for name, n in layout.experts.items():
        experts = getattr(model, name)
        keep = _expert_keys(n, rank, tp)
        for key in list(experts):
            if key not in keep:
                del experts[key]
    if layout.experts:
        model.expert_tp = group
    model.tp_layout = layout
    return layout


def local_from_full(layout: TPLayout, full: dict) -> dict:
    """A rank's slices of a full name -> tensor dict (the reference
    layout), for the names of this rank's model that `full` holds."""
    out = {}
    for name, v in full.items():
        spec = layout.plan.get(name)
        if spec == EXPERT:
            ns, key = name.split(".", 2)[:2]
            if key not in _expert_keys(layout.experts[ns], layout.rank,
                                       layout.world):
                continue
        elif isinstance(spec, Shard):
            lo, hi = _span(spec, v.shape[spec.dim], layout.rank,
                           layout.world)
            v = v.narrow(spec.dim, lo, hi - lo)
        out[name] = v
    return out


def _gather_shard(v, spec: Shard, full_size: int, layout: TPLayout):
    """A sharded tensor's parts from the tp ranks, joined; parts of
    unequal size (a joint layer's) travel padded to the largest."""
    spans = [_span(spec, full_size, r, layout.world)
             for r in range(layout.world)]
    width = max(hi - lo for lo, hi in spans)
    pad = list(v.shape)
    pad[spec.dim] = width - v.shape[spec.dim]
    padded = torch.cat([v, v.new_zeros(pad)], spec.dim)
    parts = all_gather(padded, spec.dim, layout.group).split(width,
                                                             spec.dim)
    return torch.cat([p.narrow(spec.dim, 0, hi - lo)
                      for p, (lo, hi) in zip(parts, spans)], spec.dim)


def gather_full(layout: TPLayout, local: dict, names=None) -> dict:
    """The full name -> tensor dict of every rank's slices in `local` (a
    state_dict, or Adam's moments by parameter name): collectives over
    the tp group, which every rank of it calls alike. names: the full
    keys to give, in order (default: the full state_dict's)."""
    names = layout.names if names is None else names
    out = {}
    experts = {}
    for name in names:
        spec = layout.plan.get(name)
        if spec == EXPERT:
            ns, key, rest = name.split(".", 2)
            experts.setdefault((ns, rest), []).append(name)
        elif isinstance(spec, Shard):
            out[name] = _gather_shard(local[name], spec,
                                      layout.shapes[name][spec.dim], layout)
        else:
            out[name] = local[name]
    for (ns, rest), full_names in experts.items():
        mine = torch.stack([local[f"{ns}.{k}.{rest}"] for k in _expert_keys(
            layout.experts[ns], layout.rank, layout.world)])
        every = all_gather(mine, 0, layout.group)
        for name in full_names:
            out[name] = every[int(name.split(".", 2)[1])]
    return {n: out[n] for n in names}
