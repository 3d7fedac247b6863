"""GRU with torch's gate semantics (counterpart of mvae_tpu/nn/rnn.py).

Gates laid out [r|z|n], as torch's nn.GRU stores them:
    r  = sigmoid(x W_ir + b_ir + h W_hr + b_hr)
    z  = sigmoid(x W_iz + b_iz + h W_hz + b_hz)
    n  = tanh(x W_in + b_in + r * (h W_hn + b_hn))
    h' = (1 - z) * n + z * h

Each step is the cell's own two matmuls and its gate arithmetic, the
formula the JAX package computes in jnp (no Pallas kernel there, and no
cuDNN RNN here). `GRU` holds the parameters of a torch nn.GRU under its
keys (weight_ih_l0, ..., `_reverse` for the backward direction), so a
reference `state_dict` loads with strict=True; its forward is not nn.GRU's
but the functions below. Used by the MultiMNIST text modality
(reference multimnist/model.py:145-235).
"""

import torch
from torch import nn

from mvae_tpu_torch.nn.initializers import kaiming_uniform_bound, uniform_
from mvae_tpu_torch.nn.layers import linear


def gru_cell(p, x, h):
    """One step. p: (w_ih (3H, D_in), w_hh (3H, H), b_ih, b_hh (3H,)), torch
    layout; x: (B, D_in), h: (B, H) -> h' (B, H)."""
    w_ih, w_hh, b_ih, b_hh = p
    gi = linear(x, w_ih, b_ih)
    gh = linear(h, w_hh, b_hh)
    i_r, i_z, i_n = gi.chunk(3, dim=-1)
    h_r, h_z, h_n = gh.chunk(3, dim=-1)
    r = torch.sigmoid(i_r + h_r)
    z = torch.sigmoid(i_z + h_z)
    n = torch.tanh(i_n + r * h_n)
    return (1.0 - z) * n + z * h


def gru_layer(p, xs, h0):
    """Run the cell over time. xs: (T, B, D_in), h0: (B, H) -> (ys (T, B,
    H), hT)."""
    h, ys = h0, []
    for x in xs:
        h = gru_cell(p, x, h)
        ys.append(h)
    return torch.stack(ys), h


def bigru_last_step(p_fwd, p_bwd, xs):
    """A bidirectional GRU's last output step (torch's `output[-1]`): the
    forward hidden after the whole sequence, and the backward direction's
    hidden after its first step, which sees only xs[-1]."""
    h0 = xs.new_zeros((xs.shape[1], p_fwd[1].shape[1]))
    _, h_fwd = gru_layer(p_fwd, xs, h0)
    return h_fwd, gru_cell(p_bwd, xs[-1], h0)


class GRU(nn.Module):
    """The parameters of torch.nn.GRU(d_in, hidden, num_layers,
    bidirectional) under its keys; `cell(layer, reverse)` gives one
    direction's (w_ih, w_hh, b_ih, b_hh) for gru_cell."""

    def __init__(self, d_in: int, hidden: int, num_layers: int = 1, *,
                 bidirectional: bool = False, device=None):
        super().__init__()
        self.hidden = hidden
        dirs = ("", "_reverse") if bidirectional else ("",)
        for layer in range(num_layers):
            for sfx in dirs:
                d = d_in if layer == 0 else hidden * len(dirs)
                name = f"_l{layer}{sfx}"
                for kind, shape in (("weight_ih", (3 * hidden, d)),
                                    ("weight_hh", (3 * hidden, hidden)),
                                    ("bias_ih", (3 * hidden,)),
                                    ("bias_hh", (3 * hidden,))):
                    self.register_parameter(kind + name, nn.Parameter(
                        torch.empty(shape, device=device)))

    def reset_parameters(self, generator):
        """torch's GRU init: every tensor U(-1/sqrt(H), 1/sqrt(H))."""
        bound = kaiming_uniform_bound(self.hidden)
        for p in self.parameters():
            uniform_(p, bound, generator)

    def cell(self, layer: int = 0, reverse: bool = False):
        sfx = f"_l{layer}" + ("_reverse" if reverse else "")
        return tuple(getattr(self, k + sfx) for k in (
            "weight_ih", "weight_hh", "bias_ih", "bias_hh"))
