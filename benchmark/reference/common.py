"""What the plain references share: the layer stacks a configuration file
lists, run in plain PyTorch on a dict of named tensors, the multi-term
ELBO train step with Adam and the BatchNorm running statistics, and the
IWAE estimate.

Everything runs in float32 with TF32 off (`no_tf32`). The key names are
those of the published model's `state_dict` (mhw32/multimodal-vae-public),
derived from the stacks the same way nn.Sequential numbers its layers:
each entry of a stack takes the next index, except the shape changes
("flatten", "unflatten", "nchw", "nhwc").

A stack entry is a list: ["conv", in, out, k, stride, pad] (no bias),
["convT", in, out, k, stride, pad] (no bias), ["linear", in, out],
["embed", rows, width], ["bn", channels], ["swish"], ["dropout", rate],
["flatten"], ["unflatten", c, h, w], ["nchw"], ["nhwc"].

`quant`, where given, rounds each operand of a convolution or matrix
product, and the gradient that flows back into it, to a lower precision
(the control of the benchmark's comparison, checks.py): the reference
computed in that precision, accumulating in float32.

Nothing here imports the program under test.
"""

import contextlib
import math

import torch
import torch.nn.functional as F

BN_EPS = 1e-5
BN_MOMENTUM = 0.1
POE_EPS = 1e-8
ADAM = dict(b1=0.9, b2=0.999, eps=1e-8)
SHAPE_OPS = ("flatten", "unflatten", "nchw", "nhwc")


@contextlib.contextmanager
def no_tf32(allow=False):
    """float32 matrix products and convolutions without TF32 (with it,
    allow=True: the scoring control); restored after."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = allow
    torch.backends.cudnn.allow_tf32 = allow
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def indexed(stack):
    """(index or None, entry) for each entry of a stack."""
    i = 0
    for entry in stack:
        if entry[0] in SHAPE_OPS:
            yield None, entry
        else:
            yield i, entry
            i += 1


def stack_params(prefix, stack):
    """name -> (shape, fan_in or None, kind) of a stack's tensors; kind
    is "weight", "bias", "embed", "bn_weight", "bn_bias", "bn_mean",
    "bn_var" or "bn_count"."""
    out = {}
    for i, e in indexed(stack):
        key = f"{prefix}.{i}"
        op = e[0]
        if op == "conv":
            _, cin, cout, k = e[:4]
            out[f"{key}.weight"] = ((cout, cin, k, k), cin * k * k, "weight")
        elif op == "convT":
            # torch takes a transposed convolution's fan_in from its
            # output channels
            _, cin, cout, k = e[:4]
            out[f"{key}.weight"] = ((cin, cout, k, k), cout * k * k, "weight")
        elif op == "linear":
            _, din, dout = e
            out[f"{key}.weight"] = ((dout, din), din, "weight")
            out[f"{key}.bias"] = ((dout,), din, "bias")
        elif op == "embed":
            out[f"{key}.weight"] = ((e[1], e[2]), None, "embed")
        elif op == "bn":
            c = e[1]
            out[f"{key}.weight"] = ((c,), None, "bn_weight")
            out[f"{key}.bias"] = ((c,), None, "bn_bias")
            out[f"{key}.running_mean"] = ((c,), None, "bn_mean")
            out[f"{key}.running_var"] = ((c,), None, "bn_var")
            out[f"{key}.num_batches_tracked"] = ((), None, "bn_count")
    return out


class _Round(torch.autograd.Function):
    """quant(x) forward, quant(gradient) backward."""

    @staticmethod
    def forward(ctx, x, quant):
        ctx.quant = quant
        return quant(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.quant(g), None


def fp8_e4m3(t):
    """t rounded to float8 e4m3 with one scale a tensor (its largest
    magnitude at the format's largest value), back in float32."""
    amax = t.detach().abs().amax().float().clamp(min=1e-30)
    scale = 448.0 / amax
    return (t * scale).to(torch.float8_e4m3fn).to(t.dtype) / scale


QUANTS = {"fp8_e4m3": fp8_e4m3}


class Ops:
    """The plain operations, with an optional rounding of each product's
    operands (module docstring)."""

    def __init__(self, quant=None):
        self.quant = None if quant is None else QUANTS[quant]

    def q(self, t):
        return t if self.quant is None else _Round.apply(t, self.quant)

    def conv(self, x, w, stride, pad):
        return F.conv2d(self.q(x), self.q(w), stride=stride, padding=pad)

    def conv_t(self, x, w, stride, pad):
        return F.conv_transpose2d(self.q(x), self.q(w), stride=stride,
                                  padding=pad)

    def linear(self, x, w, b):
        return self.q(x) @ self.q(w).t() + b


def swish(x):
    return x * torch.sigmoid(x)


class BNState:
    """A train-mode run's batch statistics a BN layer and the order of
    their commits: key -> [(mean, unbiased var), ...]."""

    def __init__(self):
        self.commits = {}

    def add(self, key, mean, var_unbiased, times=1):
        self.commits.setdefault(key, []).extend(
            [(mean.detach(), var_unbiased.detach())] * times)

    @torch.no_grad()
    def apply(self, params):
        """Each commit in order: running = (1 - m) running + m stat."""
        for key, stats in self.commits.items():
            rm = params[f"{key}.running_mean"]
            rv = params[f"{key}.running_var"]
            for mean, var in stats:
                rm.mul_(1.0 - BN_MOMENTUM).add_(BN_MOMENTUM * mean)
                rv.mul_(1.0 - BN_MOMENTUM).add_(BN_MOMENTUM * var)


def batch_norm(x, p, key, train, bn, times=1):
    """BatchNorm over the rows (and positions) of x, channel axis 1: batch
    statistics in train mode (committed `times` times to bn), the running
    ones in eval mode."""
    dims = [0] + list(range(2, x.ndim))
    shape = [1, -1] + [1] * (x.ndim - 2)
    if train:
        mean = x.mean(dim=dims)
        var = x.var(dim=dims, unbiased=False)
        n = x.numel() // x.shape[1]
        if bn is not None and times:
            bn.add(key, mean, var * (n / max(n - 1, 1)), times)
    else:
        mean, var = p[f"{key}.running_mean"], p[f"{key}.running_var"]
    y = (x - mean.view(shape)) * torch.rsqrt(var.view(shape) + BN_EPS)
    return y * p[f"{key}.weight"].view(shape) + p[f"{key}.bias"].view(shape)


def run_stack(ops, p, prefix, stack, x, *, train=False, bn=None, times=1,
              keep=None):
    """x through a stack. keep: the dropout's keep-mask in train mode."""
    for i, e in indexed(stack):
        op, key = e[0], f"{prefix}.{i}"
        if op == "conv":
            x = ops.conv(x, p[f"{key}.weight"], e[4], e[5])
        elif op == "convT":
            x = ops.conv_t(x, p[f"{key}.weight"], e[4], e[5])
        elif op == "linear":
            x = ops.linear(x, p[f"{key}.weight"], p[f"{key}.bias"])
        elif op == "embed":
            x = p[f"{key}.weight"][x.long()]
        elif op == "bn":
            x = batch_norm(x, p, key, train, bn, times)
        elif op == "swish":
            x = swish(x)
        elif op == "dropout":
            if train:
                x = torch.where(keep, x / (1.0 - e[1]), 0.0)
        elif op == "flatten":
            x = x.reshape(x.shape[0], -1)
        elif op == "unflatten":
            x = x.reshape(x.shape[0], *e[1:])
        elif op == "nchw":
            x = x.permute(0, 3, 1, 2)
        elif op == "nhwc":
            x = x.permute(0, 2, 3, 1)
        else:
            raise ValueError(f"unknown layer {e}")
    return x


def bce_with_logits(x, t):
    """Elementwise BCE with logits, stable form."""
    return x.clamp(min=0) - x * t + torch.log1p(torch.exp(-x.abs()))


def poe(mu, logvar, mask):
    """Product of experts of the experts mask (M,) selects, with the
    N(0, I) prior: mu, logvar (M, B, D) -> (B, D) each."""
    m = mask.view(-1, 1, 1)
    t = 1.0 / (torch.exp(logvar) + POE_EPS)
    den = (m * t).sum(0) + 1.0 / (1.0 + POE_EPS)
    return (m * mu * t).sum(0) / den, -torch.log(den)


def kl_normal(mu, logvar):
    return -0.5 * torch.sum(1.0 + logvar - mu.square() - torch.exp(logvar),
                            dim=-1)


def term_loss(model, p, ops, inputs, mu, logvar, mask, w, beta, eps, bn):
    """One term of the ELBO: its posterior from the experts `mask` (M,)
    selects and the prior, the decode of every modality (model.recon, w
    (M,) its weights), the weighted reconstruction losses plus beta times
    the KL, the mean over the batch."""
    q_mu, q_lv = poe(mu, logvar, mask)
    z = q_mu + eps * torch.exp(0.5 * q_lv)
    recon = model.recon(p, ops, z, inputs, w, bn)
    return torch.mean(recon + beta * kl_normal(q_mu, q_lv))


def _add(a, b):
    return b if a is None else a if b is None else a + b


def elbo(model, p, ops, inputs, masks, lambdas, beta, eps, keep, bn,
         recon_masks=None, wrt=None):
    """The multi-term ELBO of one step, as the published training loop
    computes it: each term's posterior from its experts and the prior,
    its decode of every modality (a decoder the term's loss does not
    weight runs for its BatchNorm statistics alone, or not at all where
    it has none), the weighted reconstruction losses plus beta times the
    KL, the mean over the batch, summed over the terms. masks (T, M) pick
    each term's experts (and how often an encoder's BatchNorms commit);
    a term's reconstruction weights are (recon_masks, else masks) x
    lambdas. model: the family's module (celeba.py, celeba19.py).
    Returns (total, per_term).

    wrt: names of p to take the total's gradient with respect to, a term
    at a time, so that one term's decodes are held at once: each term's
    gradient flows into the decoders and into the encoders' outputs,
    detached, and frees its graph; the encoders' backward runs once, from
    the terms' summed gradient. Returns (total, per_term, grads), grads
    name -> tensor, or None where the total does not reach it."""
    recon = masks if recon_masks is None else recon_masks
    mu, logvar = model.encode(p, ops, inputs, keep, bn,
                              masks.sum(0).round().long().tolist())
    terms = range(masks.shape[0])
    if wrt is None:
        per_term = torch.stack([
            term_loss(model, p, ops, inputs, mu, logvar, masks[t],
                      recon[t] * lambdas[t], beta, eps[t], bn)
            for t in terms])
        return per_term.sum(), per_term
    leaves = [p[k] for k in wrt]
    mu_d, lv_d = (v.detach().requires_grad_(True) for v in (mu, logvar))
    grads, d_mu, d_lv, per_term = [None] * len(leaves), None, None, []
    for t in terms:
        term = term_loss(model, p, ops, inputs, mu_d, lv_d, masks[t],
                         recon[t] * lambdas[t], beta, eps[t], bn)
        *g, g_mu, g_lv = torch.autograd.grad(term, leaves + [mu_d, lv_d],
                                             allow_unused=True)
        grads = [_add(a, b) for a, b in zip(grads, g)]
        d_mu, d_lv = _add(d_mu, g_mu), _add(d_lv, g_lv)
        per_term.append(term.detach())
    outs = [(o, d) for o, d in ((mu, d_mu), (logvar, d_lv)) if d is not None]
    g = torch.autograd.grad([o for o, _ in outs], leaves,
                            grad_outputs=[d for _, d in outs],
                            allow_unused=True)
    grads = [_add(a, b) for a, b in zip(grads, g)]
    per_term = torch.stack(per_term)
    return per_term.sum(), per_term, dict(zip(wrt, grads))


def trained(key):
    """Whether a state_dict entry is a trained parameter (not a BN's
    running statistic or count)."""
    return not key.endswith(("running_mean", "running_var",
                             "num_batches_tracked"))


def train_steps(model, params, ops, steps, lr, beta, keep_after=None):
    """The plain train step, repeated: params name -> float32 tensor (the
    model's state_dict), updated in place; steps: an iterable of (inputs,
    masks, lambdas, eps, keep, recon_masks or None) per step. Returns the
    losses, each parameter's gradient of the first step as Adam gets it,
    and a copy of params as they are after `keep_after` steps (None
    without it); leaves params as they are after the last step. The
    gradient is taken a term at a time (elbo's wrt)."""
    names = [k for k, v in params.items()
             if v.is_floating_point() and trained(k)]
    for k in names:
        params[k].requires_grad_(True)
    m = {k: torch.zeros_like(params[k]) for k in names}
    v = {k: torch.zeros_like(params[k]) for k in names}
    losses, first, kept = [], None, None
    for n, (inputs, masks, lambdas, eps, keep, recon_masks) in enumerate(
            steps, 1):
        if n - 1 == keep_after:
            kept = {k: t.detach().clone() for k, t in params.items()}
        bn = BNState()
        total, _, grads = elbo(model, params, ops, inputs, masks, lambdas,
                               beta, eps, keep, bn, recon_masks, wrt=names)
        grads = {k: (torch.zeros_like(params[k]) if g is None else g)
                 for k, g in grads.items()}
        if first is None:
            first = {k: g.detach().clone() for k, g in grads.items()}
        losses.append(float(total.detach()))
        with torch.no_grad():
            b1, b2, e = ADAM["b1"], ADAM["b2"], ADAM["eps"]
            for k in names:
                g = grads[k]
                m[k].mul_(b1).add_((1 - b1) * g)
                v[k].mul_(b2).add_((1 - b2) * g * g)
                m_hat = m[k] / (1 - b1 ** n)
                v_hat = v[k] / (1 - b2 ** n)
                params[k].sub_(lr * m_hat / (v_hat.sqrt() + e))
            bn.apply(params)
        del total, grads
    if keep_after is not None and kept is None:
        kept = {k: t.detach().clone() for k, t in params.items()}
    for k in names:
        params[k].requires_grad_(False)
    return losses, first, kept


@torch.no_grad()
def iwae(model, p, ops, inputs, proposal, targets, eps, block=10):
    """log p(targets) >= logsumexp_k [log p(x|z_k) + log p(z_k) -
    log q(z_k|x)] - log K, per row: eval mode, q the product of the
    proposal's experts and the prior, eps (K, B, D), the decodes in
    blocks of `block` samples."""
    mu, logvar = model.encode(p, ops, inputs, None, None, None)
    q_mu, q_lv = poe(mu, logvar, proposal)
    k = eps.shape[0]
    z = q_mu + eps * torch.exp(0.5 * q_lv)                       # (K, B, D)
    log_px = []
    for lo in range(0, k, block):
        zb = z[lo:lo + block]
        flat = zb.reshape(-1, zb.shape[-1])
        log_px.append(-model.target_loss(p, ops, flat, inputs, targets)
                      .reshape(zb.shape[0], -1))
    log_pz = -0.5 * torch.sum(math.log(2 * math.pi) + z.square(), dim=-1)
    log_q = -0.5 * torch.sum(q_lv + math.log(2 * math.pi)
                             + (z - q_mu).square() * torch.exp(-q_lv), dim=-1)
    log_w = torch.cat(log_px) + log_pz - log_q
    return torch.logsumexp(log_w, dim=0) - math.log(k)
