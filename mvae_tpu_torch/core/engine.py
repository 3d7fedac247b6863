"""Multi-term ELBO engine (counterpart of mvae_tpu/core/engine.py:48-281).

  1. Encode every modality once.
  2. Fuse all T subset posteriors in one PoE kernel launch.
  3. z = mu in eval mode; z = mu + eps * exp(logvar / 2) in train mode,
     eps (T, B, D) from the caller.
  4. Decode. A train step with a decode plan (decode_plan: the terms
     grouped by their static recon support, the JAX package's
     `_decode_grouped`) decodes each decoder group on the rows of the
     terms that train it, with autograd; on the rows of the terms that
     never train it (a recon weight statically 0) it runs forward alone
     under no_grad where the group has BatchNorm, so that its batch
     statistics and EMA commits are the reference's, and not at all where
     it has none (the model's exact_skip_groups) or where
     --fast-term-decode skips it (skip_decode_groups). Each call keeps
     one set of BN statistics a term and names its terms in its
     Moments; celeba19's single-attribute terms decode only their own
     expert (gathered_groups). Eval steps, and train steps whose terms
     all decode everything (vision; a support of all ones), decode the
     T*B rows as one batch: every BN keeps T sets of statistics, those of
     the JAX package's vmap over terms. The two decodes give the same
     values and gradients (a dead term's gradient is exactly 0 in the
     one batch too); the grouped one does not run the dead work.
  5. Masked, weighted reconstruction losses (the logit rows share the B
     target rows; on the grouped path each call's loss rows, scattered
     into the (T, B, M) stack, 0 where no call trains the column) plus
     the per-term KL.
  6. Train mode: commit the BN running statistics (commit_ema_states).

The engine draws no random numbers: train mode takes `noise = (eps,
keep_mask[, decode_keep_mask])` from the caller. Steps 1, 2-3, each
decode call (decode.train with autograd, decode.stats forward alone), 5
and 6 run under the profiler spans mvae.engine.* (utils/profiling.py),
the whole under mvae.engine.elbo.
"""

import contextlib
from typing import NamedTuple

import numpy as np
import torch

from mvae_tpu_torch.core.losses import kl_divergence
from mvae_tpu_torch.core.sampling import reparametrize
from mvae_tpu_torch.nn.norm import BN_MOMENTUM
from mvae_tpu_torch.ops.poe import masked_poe_all_terms
from mvae_tpu_torch.utils.profiling import span


@torch.no_grad()
def commit_ema_states(model, enc_moments, dec_moments, term_masks):
    """Fold the reference's sequential BN-EMA commits into the running
    buffers, in place, in the closed forms of engine.py:48-86.

    The reference runs one forward per term: every decoder BN gets T
    commits in term order, and modality m's encoder BNs get
    k = sum(term_masks[:, m]) commits, all of the same batch moments. With
    s_t = (1-mom) old + mom m_t the T decoder commits fold to
        new = (1-mom)^T old + sum_t (1-mom)^(T-1-t) (s_t - (1-mom) old)
    and the k encoder commits to
        new = old + ((1 - (1-mom)^k) / mom) (s - old).
    The variance committed is the unbiased one, var * n / (n - 1).

    enc_moments: modality -> [Moments] (G = 1); dec_moments: [Moments],
    one or several a BN layer: one with G = T (the one-batch decode), or
    each with the G terms its Moments.terms names (the grouped decode's
    calls); a term that no Moments of a layer names commits s_t = old,
    the state a skipped decode returns in the JAX package
    (engine.py:_decode_grouped); term_masks: (T, M).
    """
    mom = BN_MOMENTUM
    t = term_masks.shape[0]
    w = (1.0 - mom) ** torch.arange(t - 1, -1, -1, dtype=torch.float32,
                                    device=term_masks.device)[:, None]

    def unbiased(m):
        return m.var * (m.n / max(m.n - 1, 1))

    by_bn = {}
    for m in dec_moments:
        by_bn.setdefault(id(m.bn), []).append(m)
    for ms in by_bn.values():
        bn = ms[0].bn
        terms = None
        if ms[0].terms is not None:
            terms = (ms[0].terms if len(ms) == 1
                     else torch.cat([m.terms for m in ms]))
        for buf, stats in ((bn.running_mean, [m.mean for m in ms]),
                           (bn.running_var, [unbiased(m) for m in ms])):
            stat = stats[0] if len(stats) == 1 else torch.cat(stats)
            s = (1.0 - mom) * buf + mom * stat                  # (G, C)
            if terms is not None:
                s = buf.expand(t, -1).index_copy(0, terms, s)   # (T, C)
            buf.copy_((1.0 - mom) ** t * buf
                      + torch.sum(w * (s - (1.0 - mom) * buf), dim=0))
    for name, moments in enc_moments.items():
        k = term_masks[:, model.modality_index(name)].sum()
        q = 1.0 - (1.0 - mom) ** k
        for m in moments:
            for buf, stat in ((m.bn.running_mean, m.mean[0]),
                              (m.bn.running_var, unbiased(m)[0])):
                s = (1.0 - mom) * buf + mom * stat
                buf.add_((q / mom) * (s - buf))


def static_support(term_masks, term_lambdas, recon_masks=None):
    """(T, M) 0/1 support of the recon weights known before the step
    (train/loop.py:54-59): (recon_masks, else term_masks) * term_lambdas
    != 0."""
    base = term_masks if recon_masks is None else recon_masks
    w = (np.asarray(base, np.float64)
         * np.asarray(term_lambdas, np.float64))
    return (w != 0).astype(np.float32)


class DecodeCall(NamedTuple):
    """One decode of a decoder group in the grouped train step: on the rows
    of the ELBO terms `index` (host ints, ascending; `terms` the same on
    the device), with autograd (`grad`: a term of them trains the group)
    or forward alone (BN statistics only); `operand` the model's
    decode_term_operands of their support rows for a gathered group,
    else None."""
    index: tuple
    terms: torch.Tensor
    grad: bool
    operand: object


class GroupPlan(NamedTuple):
    """A decoder group's calls, the live ones first, and how their loss
    rows return to term order: the live calls' rows, then `n_zero` rows
    of zeros (its dead and skipped terms), taken in the order `perm` ((T,)
    long, or None where that order is the terms')."""
    name: str
    columns: tuple
    calls: tuple
    n_zero: int
    perm: object


def decode_plan(model, recon_support, *, fast_skip_decode=False,
                device=None):
    """The grouped decode of a train step whose recon weights have the
    static support recon_support ((T, M) 0/1, numpy): a tuple of
    GroupPlan, one a decoder group in model.decoder_columns() order; None
    where the terms fall in one group that decodes everything (the
    one-batch decode serves it). As engine.py:_decode_grouped groups them:
    by (model.stop_grad_groups(row), model.decode_group_key(row)); a
    group a term never trains is decoded forward alone for that term
    (BN statistics), or skipped where it is in the model's
    exact_skip_groups or, under fast_skip_decode, skip_decode_groups.
    The keys split only the calls of gathered_groups."""
    if recon_support is None:
        return None
    support = np.asarray(recon_support, np.float32)
    key_of = getattr(model, "decode_group_key", lambda row: None)
    keys = [(model.stop_grad_groups(tuple(row)), key_of(tuple(row)))
            for row in support]
    if len(set(keys)) == 1 and not keys[0][0] and keys[0][1] is None:
        return None
    skippable = set(model.exact_skip_groups)
    if fast_skip_decode:
        skippable |= set(model.skip_decode_groups)
    t = len(keys)

    def on_device(ts):
        return torch.as_tensor(ts, dtype=torch.long, device=device)

    plan = []
    for name, columns in model.decoder_columns().items():
        live, dead = {}, []
        for i, (stop, key) in enumerate(keys):
            if name not in stop:
                by = key if name in model.gathered_groups else None
                live.setdefault(by, []).append(i)
            elif name not in skippable:
                dead.append(i)
        calls = [DecodeCall(tuple(ts), on_device(ts), True,
                            None if key is None else
                            model.decode_term_operands(support[ts], device))
                 for key, ts in live.items()]
        if dead:
            calls.append(DecodeCall(tuple(dead), on_device(dead), False,
                                    None))
        order = [i for c in calls if c.grad for i in c.index]
        order += [i for i in range(t) if i not in order]
        perm = (None if order == list(range(t))
                else on_device(np.argsort(order)))
        plan.append(GroupPlan(name, tuple(columns), tuple(calls),
                              t - sum(len(c.index) for c in calls
                                      if c.grad), perm))
    return tuple(plan)


def rows_axis(shape_of, rows: int) -> int:
    """The axis of shape_of(rows) that counts the rows."""
    return next(i for i, (a, b) in enumerate(zip(shape_of(rows),
                                                 shape_of(rows + 1)))
                if a != b)


def _term_rows(x, axis, t, call):
    """The rows of call's terms of x, whose `axis` holds T blocks of rows
    (term-major), as one axis again: a view where the terms are
    consecutive."""
    shape = x.shape
    blocks = x.reshape(shape[:axis] + (t, -1) + shape[axis + 1:])
    lo, n = call.index[0], len(call.index)
    if call.index == tuple(range(lo, lo + n)):
        rows = blocks.narrow(axis, lo, n)
    else:
        rows = blocks.index_select(axis, call.terms)
    return rows.reshape(shape[:axis] + (-1,) + shape[axis + 1:])


def _decode_grouped(model, z, plan, inputs, keep_mask):
    """Step 4 on the plan's calls: the (T, B, M) loss stack and the
    decoders' Moments (module docstring)."""
    t, b, d = z.shape
    z = z.reshape(t * b, d)
    ax = (None if keep_mask is None
          else rows_axis(model.decode_keep_mask_shape, t * b))
    blocks, moments = [], []
    for group in plan:
        parts = []
        width = group.columns[1] - group.columns[0]
        for call in group.calls:
            kw = {}
            if keep_mask is not None:
                kw["keep_mask"] = _term_rows(keep_mask, ax, t, call)
            if call.operand is not None:
                kw["operand"] = call.operand
            rows = _term_rows(z, 0, t, call)
            with span("mvae.engine.decode.train" if call.grad
                      else "mvae.engine.decode.stats"):
                with (contextlib.nullcontext() if call.grad
                      else torch.no_grad()):
                    recons, ms = model.decode_group(
                        group.name, rows if call.grad else rows.detach(),
                        len(call.index), call.terms, **kw)
                moments += ms
                if call.grad:
                    loss = model.group_losses(group.name, recons, inputs)
                    parts.append(loss.reshape(len(call.index), b, width))
        if group.n_zero:
            parts.append(z.new_zeros((group.n_zero, b, width)))
        block = parts[0] if len(parts) == 1 else torch.cat(parts)
        if group.perm is not None:
            block = block.index_select(0, group.perm)
        blocks.append(block)
    stack = blocks[0] if len(blocks) == 1 else torch.cat(blocks, dim=-1)
    return stack, moments


def multi_term_elbo(model, inputs, term_masks, term_lambdas, beta=1.0, *,
                    train: bool = False, noise=None, plan=None,
                    recon_masks=None):
    """Sum over T subset-ELBO terms.

    inputs:       name -> (B, ...) tensors, every modality present.
    term_masks:   (T, M) 0/1: which experts join each term's posterior,
                  and (without recon_masks) which reconstruction losses
                  count in it.
    term_lambdas: (T, M) per-term, per-modality loss weights.
    recon_masks:  (T, M) 0/1 or None: which reconstruction losses count
                  in each term, apart from the posterior's experts
                  (vision's unimodal terms reconstruct all six
                  modalities; engine.py:267-268). The EMA commit keeps
                  term_masks: an encoder commits once for each term whose
                  posterior holds its modality.
    train:        the model must be in the same mode. Train mode needs
                  noise = (eps (T, B, D) standard normal, keep_mask: the
                  encoder dropout's, model.keep_mask_shape(B) bool, or
                  None for a model whose dropout_rate is 0[, the
                  decoder dropout's model.decode_keep_mask_shape(T * B),
                  for a model with a decode_dropout_rate]), and commits
                  the BN running statistics after the forward.
    plan:         decode_plan(...) of the terms' static recon support,
                  which the step's recon weights must lie within; train
                  mode only (eval decodes as one batch), or None.

    Returns (total, aux) with aux = {"per_term": (T,), "mu", "logvar":
    the first term's posterior (B, D)}.
    """
    if train != model.training:
        raise ValueError(f"train={train} but the model is in "
                         f"{'train' if model.training else 'eval'} mode")
    dec_dropout = getattr(model, "decode_dropout_rate", 0.0)
    if train and (noise is None or noise[0] is None
                  or (model.dropout_rate and noise[1] is None)
                  or (dec_dropout and (len(noise) < 3 or noise[2] is None))):
        raise ValueError("train mode takes noise = (eps, keep_mask[, "
                         "decode_keep_mask]); a keep_mask may be None only "
                         "without that dropout")
    eps, keep_mask = noise[:2] if train else (None, None)
    dec_keep = noise[2] if train and dec_dropout else None
    with span("mvae.engine.elbo"):
        with span("mvae.engine.encode"):
            mu, logvar, enc_moments = model.encode(inputs, keep_mask)
        with span("mvae.engine.fuse"):
            pd_mu, pd_logvar = masked_poe_all_terms(mu, logvar, term_masks)
            z = reparametrize(pd_mu, pd_logvar, eps)             # (T, B, D)
        t, b, d = z.shape
        if train and plan is not None:
            recon_stack, dec_moments = _decode_grouped(model, z, plan,
                                                       inputs, dec_keep)
        else:
            kw = {} if dec_keep is None else {"keep_mask": dec_keep}
            with span("mvae.engine.decode.train"):
                recons, dec_moments = model.decode(z.reshape(t * b, d),
                                                   groups=t, **kw)
                recon_stack = model.recon_losses(recons, inputs).reshape(
                    t, b, -1)
        with span("mvae.engine.loss"):
            rmask = term_masks if recon_masks is None else recon_masks
            w = (rmask * term_lambdas)[:, None, :]             # (T, 1, M)
            recon = torch.sum(recon_stack * w, dim=-1)         # (T, B)
            kld = kl_divergence(pd_mu, pd_logvar)              # (T, B)
            per_term = torch.mean(recon + beta * kld, dim=1)   # (T,)
            total = torch.sum(per_term)
        if train:
            with span("mvae.engine.commit"):
                commit_ema_states(model, enc_moments, dec_moments,
                                  term_masks)
    return total, {"per_term": per_term, "mu": pd_mu[0],
                   "logvar": pd_logvar[0]}
