"""Plain reference of the CelebA MVAE (Wu & Goodman 2018; mhw32/multimodal-
vae-public, celeba/model.py and celeba/train.py): a 64x64 RGB image and
its 18 binary attributes, one expert each.

    image encoder   conv 3->32->64->128->256 (BN from the second), swish,
                    fc 6400 -> 512, swish, dropout, fc -> 2L
    image decoder   fc L -> 6400, swish, convT 256->128->64->32->3 (BN +
                    swish between), logits
    attrs encoder   18 -> 512 -> 512 (BN1d + swish) -> 2L
    attrs decoder   L -> 512 x 3 (BN1d + swish) -> 18 logits

The sizes come from the configuration file's stacks (common.py). The
losses are the row sums of the BCE with logits; a decoder that a term's
loss leaves at weight 0 still runs in train mode for its BatchNorm
statistics, as the published loop's forward of every term does.
"""

import torch

from reference.common import bce_with_logits, run_stack


class Model:
    """The family's encode, decode and losses over a dict of tensors in
    the published key names; `cfg` is the configuration file."""

    def __init__(self, cfg):
        self.experts = expand_experts(cfg["experts"], cfg["stacks"])
        self.n_latents = cfg["n_latents"]

    def expert_input(self, name, inputs):
        return inputs[name]

    def target(self, name, inputs):
        return inputs[name]

    def _run(self, p, ops, stacks, x, **kw):
        for prefix, stack in stacks:
            x = run_stack(ops, p, prefix, stack, x, **kw)
        return x

    def encode(self, p, ops, inputs, keep, bn, commits):
        """(M, B, L) mu and logvar; in train mode (bn given) each encoder's
        BatchNorms commit as many times as terms hold its expert. keep:
        the dropout's keep-mask, (B, width) where one encoder holds a
        dropout, or (E, B, width), a row for each of the E encoders that
        do, in expert order."""
        train = bn is not None
        mus, lvs, row = [], [], 0
        for m, e in enumerate(self.experts):
            k = keep
            if e["dropout"] and keep is not None and keep.ndim == 3:
                k, row = keep[row], row + 1
            h = self._run(p, ops, e["encoder"], self.expert_input(
                e["name"], inputs), train=train, bn=bn,
                times=commits[m] if train else 1, keep=k)
            mus.append(h[:, :self.n_latents])
            lvs.append(h[:, self.n_latents:])
        return torch.stack(mus), torch.stack(lvs)

    def decode(self, p, ops, e, z, train=False, bn=None):
        return self._run(p, ops, e["decoder"], z, train=train, bn=bn)

    def loss(self, name, logits, target):
        """(N,) row sums of the BCE; target rows shared by groups of
        rows."""
        n, nt = logits.shape[0], target.shape[0]
        x = logits.reshape(n // nt, nt, -1)
        t = target.reshape(1, nt, -1)
        return bce_with_logits(x, t).sum(-1).reshape(n)

    def recon(self, p, ops, z, inputs, w, bn):
        """One term's weighted reconstruction loss (B,), w (M,) its weights
        a modality; a decoder at weight 0 runs for its BN statistics
        alone where it has any."""
        out = 0.0
        for m, e in enumerate(self.experts):
            if float(w[m]) != 0.0:
                logits = self.decode(p, ops, e, z, True, bn)
                out = out + w[m] * self.loss(
                    e["name"], logits, self.target(e["name"], inputs))
            elif e["bn"]:
                with torch.no_grad():
                    self.decode(p, ops, e, z, True, bn)
        return out

    def target_loss(self, p, ops, z, inputs, targets):
        """The summed loss of the named targets over the rows z (eval
        mode)."""
        out = 0.0
        for e in self.experts:
            if e["name"] in targets:
                out = out + self.loss(e["name"], self.decode(p, ops, e, z),
                                      self.target(e["name"], inputs))
        return out


def expand_experts(experts, stacks):
    """The configuration's experts, each with its encoder's and decoder's
    (prefix, stack) lists; an expert with a "repeat" count stands for
    that many, {i} in its names numbering them."""
    out = []
    for e in experts:
        for i in range(e.get("repeat", 1)):
            def fmt(s):
                return s.format(i=i)
            out.append({
                "name": fmt(e["name"]), "index": i,
                "encoder": [(fmt(s), stacks[s]) for s in e["encoder"]],
                "decoder": [(fmt(s), stacks[s]) for s in e["decoder"]],
                "bn": any(l[0] == "bn" for s in e["decoder"]
                          for l in stacks[s]),
                "dropout": any(l[0] == "dropout" for s in e["encoder"]
                               for l in stacks[s])})
    return out
