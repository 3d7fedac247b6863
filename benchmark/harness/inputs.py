"""What the benchmark makes from --seed and hands to the program and to the
plain reference alike: the weights, the data rows, the order they are
read in, the terms of each step, and the generators the noise is drawn
from.

Every stream has a seed of its own, derived from --seed and its name, so
that one stream does not shift another. Weights are He-uniform,
U(-sqrt(6 / fan_in), sqrt(6 / fan_in)) (a transposed convolution's
fan_in from its output channels, as torch takes it), so that activations
keep their scale through the stacks as a trained model's do, and its
decoders' logits are not all near 0; biases U(-1/sqrt(fan_in),
1/sqrt(fan_in)), PyTorch's default; N(0, 1) for an embedding; BatchNorm
scale 1, shift 0, running mean 0, running variance 1. They are drawn on
the device in one call for each kind, in float32, the dtype the program
keeps its parameters in.
"""

import numpy as np
import torch

from reference.celeba import expand_experts
from reference.common import stack_params

STREAMS = ("weights", "rows", "order", "noise", "terms", "check")


def seed_of(seed: int, stream: str) -> int:
    """A 64-bit seed for one stream of --seed."""
    ss = np.random.SeedSequence([seed % 2 ** 64, STREAMS.index(stream)])
    lo, hi = ss.generate_state(2, np.uint32)
    return int(lo) | (int(hi) << 32)


def generator(seed, stream, device):
    return torch.Generator(device=device).manual_seed(seed_of(seed, stream))


def param_specs(cfg):
    """name -> (shape, fan_in, kind) of every tensor of the model's
    state_dict, in the reference's key names."""
    specs = {}
    for e in expand_experts(cfg["experts"], cfg["stacks"]):
        for prefix, stack in e["encoder"] + e["decoder"]:
            specs.update(stack_params(prefix, stack))
    return specs


def make_weights(cfg, seed, device):
    """The state_dict, name -> tensor on the device (module docstring)."""
    specs = param_specs(cfg)
    gen = generator(seed, "weights", device)

    def numel(shape):
        n = 1
        for d in shape:
            n *= d
        return n

    uni = [k for k, (_, _, kind) in specs.items() if kind in ("weight",
                                                              "bias")]
    emb = [k for k, (_, _, kind) in specs.items() if kind == "embed"]
    u = torch.rand(sum(numel(specs[k][0]) for k in uni), generator=gen,
                   device=device).mul_(2).sub_(1)
    n = torch.randn(max(1, sum(numel(specs[k][0]) for k in emb)),
                    generator=gen, device=device)
    out, iu, inn = {}, 0, 0
    for k, (shape, fan_in, kind) in specs.items():
        size = numel(shape)
        if kind in ("weight", "bias"):
            bound = (6.0 / fan_in if kind == "weight" else 1.0 / fan_in) ** 0.5
            out[k] = u[iu:iu + size].view(shape).mul(bound)
            iu += size
        elif kind == "embed":
            out[k] = n[inn:inn + size].view(shape).clone()
            inn += size
        elif kind == "bn_count":
            out[k] = torch.zeros((), dtype=torch.long, device=device)
        else:
            fill = 1.0 if kind in ("bn_weight", "bn_var") else 0.0
            out[k] = torch.full(shape, fill, device=device)
    return out


def make_rows(cfg, rows, seed, device):
    """The data set: name -> (rows, ...) on the device: pixels uniform
    uint8, bits 0/1 float32 with the configured share of ones."""
    gen = generator(seed, "rows", device)
    out = {}
    for name, spec in cfg["inputs"].items():
        shape = (rows,) + tuple(spec["shape"])
        if spec["kind"] == "pixels":
            out[name] = torch.randint(0, 256, shape, dtype=torch.uint8,
                                      generator=gen, device=device)
        else:
            out[name] = (torch.rand(shape, generator=gen, device=device)
                         < spec["p"]).float()
    return out


def sample_subsets(rng, count, n):
    """count subset masks (count, n) of the n experts, as the published
    CelebA-19 loop draws its sampled terms: sizes uniform over 2 .. n-1,
    distinct subsets within a size, grouped by size, ascending."""
    sizes = rng.integers(2, n, size=count)
    masks = np.zeros((count, n), np.float32)
    row = 0
    for s in sorted(set(int(v) for v in sizes)):
        seen = []
        while len(seen) < int(np.sum(sizes == s)):
            idx = tuple(sorted(rng.choice(n, size=s, replace=False)))
            if idx not in seen:
                seen.append(idx)
        for combo in seen:
            masks[row, list(combo)] = 1.0
            row += 1
    return masks


def check_terms(cfg):
    """Refuse what the harness cannot run as the configuration states it:
    `terms.recon_masks` beside sampled terms (no published configuration
    has them; a sampled term's reconstruction would be unstated), or of
    another shape than `terms.masks`. Raises ValueError naming the key."""
    t = cfg.get("terms", {})
    if "recon_masks" not in t:
        return
    if t.get("sampled", 0) > 0:
        raise ValueError("terms.recon_masks is given beside sampled terms "
                         f"(terms.sampled = {t['sampled']}): the harness "
                         "takes reconstruction masks for fixed terms only")
    rm, m = np.shape(t["recon_masks"]), np.shape(t["masks"])
    if rm != m:
        raise ValueError(f"terms.recon_masks has the shape {list(rm)}, "
                         f"terms.masks {list(m)}: they must be equal")


class Terms:
    """Each step's (T, M) masks and lambdas: the configuration's fixed
    terms, then its sampled ones (lambda `sampled_lambda`), drawn anew
    each step from the seed's "terms" stream. The masks pick each term's
    experts; `recon_masks` (fixed terms only; None without the key) the
    modalities each term reconstructs, where they are not the masks."""

    def __init__(self, cfg, seed):
        check_terms(cfg)
        t = cfg["terms"]
        self.masks = np.asarray(t["masks"], np.float32)
        self.lambdas = np.asarray(t["lambdas"], np.float32)
        self.recon_masks = (np.asarray(t["recon_masks"], np.float32)
                            if "recon_masks" in t else None)
        self.sampled = t.get("sampled", 0)
        self.sampled_lambda = t.get("sampled_lambda", 1.0)
        self.rng = np.random.default_rng(seed_of(seed, "terms"))

    @property
    def dynamic(self):
        return self.sampled > 0

    def recon_weights(self, masks, lambdas):
        """The reconstruction weights of terms (..., T, M): (recon_masks,
        else masks) x lambdas."""
        return (masks if self.recon_masks is None
                else self.recon_masks) * lambdas

    def support(self):
        """(T, M) 0/1 bound of the recon weights known before a step."""
        fixed = (self.recon_weights(self.masks, self.lambdas)
                 != 0).astype(np.float32)
        return np.concatenate(
            [fixed, np.ones((self.sampled, fixed.shape[1]), np.float32)])

    def step(self):
        if not self.dynamic:
            return self.masks, self.lambdas
        s = sample_subsets(self.rng, self.sampled, self.masks.shape[1])
        return (np.concatenate([self.masks, s]),
                np.concatenate([self.lambdas,
                                np.full_like(s, self.sampled_lambda)]))

    def window(self, k):
        """(k, T, M) masks and lambdas of k steps."""
        ms, ls = zip(*[self.step() for _ in range(k)])
        return np.stack(ms), np.stack(ls)


def keep_spec(cfg):
    """(encoders, width, rate) of the encoders' dropout: how many experts'
    encoders hold one, its rate and the width of the product before it;
    None without a dropout. The port's model draws one keep-mask row an
    encoder, in expert order, where more than one holds a dropout."""
    found = []
    for e in expand_experts(cfg["experts"], cfg["stacks"]):
        width = None
        for layer in (l for _, stack in e["encoder"] for l in stack):
            if layer[0] == "linear":
                width = layer[2]
            elif layer[0] == "dropout":
                found.append((width, layer[1]))
                break
    if not found:
        return None
    if len(set(found)) > 1:
        raise ValueError("the encoders' dropouts differ in width or rate: "
                         f"{sorted(set(found))}")
    return (len(found),) + found[0]
