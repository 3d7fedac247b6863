"""A training cell: the port's K-step window (train/loop.py:
make_multi_train_step) over the rows resident on the card, one loss
readback a window, as the train CLIs run it.

Set-up builds the model from the benchmark's weights, the step with its
Adam state, and the data set on the device, and drives that one object
through its check (Program): a call of one step, whose gradient the
comparison reads from Adam's state; WARM_CALLS calls of the window's K
steps; then one more call of the window's K steps, the checked call,
whose change of every leaf and BatchNorm running statistic the
comparison reads (checks.py). Every call is the window's own call on the
window's feed, on rows that all differ. The window runs next, on the same
object. After it the program is freed, and the plain reference follows
every step of the check from the seed's weights, on the same rows, terms
and noise.

train_samples_per_s: windows x K x B over the time from the window's
start to the synchronize after its last window (the readback of its
losses). enqueue_ms_per_step.train: the host time of each window's call,
before its readback, over K.
"""

import gc
import importlib
import time

import numpy as np
import torch

from harness import checks, inputs, port_calls, trace
from harness.yardstick import PEAK_FLOPS, train_step_flops
from reference import common as ref_common

WARM_CALLS = 1
TRACED_WINDOWS = 3


def port_model(cfg, kind, device, state):
    """The port's model of the configuration, its weights loaded strictly
    from `state`."""
    mod, cls = cfg["port"]["model"].split(":")
    model_cls = getattr(importlib.import_module(mod), cls)
    dtype = {"bfloat16": torch.bfloat16,
             "float32": None}[cfg["compute_dtype"][kind]]
    model = model_cls(cfg["n_latents"], dtype, device=device,
                      **cfg["port"]["kwargs"])
    model.load_state_dict(state, strict=True)
    return model


class Feed:
    """The window's rows and terms: a permutation of the data set's rows
    from the seed, read in order and wrapped; each step's terms."""

    def __init__(self, cfg, traffic, seed, device):
        self.rows = traffic["rows"]
        self.batch = traffic["batch"]
        self.k = traffic["steps_per_window"]
        gen = inputs.generator(seed, "order", device)
        self.perm = torch.randperm(self.rows, generator=gen, device=device)
        self.terms = inputs.Terms(cfg, seed)
        self.device = device
        self.step = 0
        self.weights = []           # each step's recon weights (host)

    def take(self, k):
        """(idxs (k, B) on the device, masks and lambdas (k, T, M) host
        arrays or None for fixed terms)."""
        lo = self.step * self.batch
        at = torch.arange(lo, lo + k * self.batch, device=self.device)
        idxs = self.perm.index_select(0, at.remainder_(self.rows))
        self.step += k
        if self.terms.dynamic:
            ms, ls = self.terms.window(k)
        else:
            ms, ls = (np.broadcast_to(a, (k,) + a.shape)
                      for a in (self.terms.masks, self.terms.lambdas))
        self.weights += list(self.terms.recon_weights(ms, ls))
        return idxs.view(k, self.batch), (
            (ms, ls) if self.terms.dynamic else None)


def _terms_kw(terms, device):
    if terms is None:
        return {}
    ms, ls = terms
    return {"masks": torch.from_numpy(ms).to(device),
            "lambdas": torch.from_numpy(ls).to(device)}


def _moved(before, after, keys):
    """name -> float64 norm of after - before."""
    return {k: float((after[k].double() - before[k].double()).norm())
            for k in keys}


def _bn_stats(keys):
    return [k for k in keys if k.endswith(("running_mean", "running_var"))]


class Program:
    """The port's training object of a cell, driven through its check
    (module docstring): the model, the K-step call, the data set and the
    feed, and what the comparison needs: `prog` (the program's numbers),
    `noise_state`, `terms`, `recon_masks` and, once freed, `rows` (each
    step's rows in order). half=True feeds every call of the check half
    of its rows (a fault the comparison has to catch; calibrate.py)."""

    def __init__(self, cfg, traffic, seed, device, half=False, log=None):
        from mvae_tpu_torch.train import loop
        log = log or (lambda msg: None)
        state = inputs.make_weights(cfg, seed, device)
        self.model = port_model(cfg, "train", device, state)
        log("model built, weights loaded")
        del state
        self.data = inputs.make_rows(cfg, traffic["rows"], seed, device)
        self.feed = feed = Feed(cfg, traffic, seed, device)
        log("rows made")
        terms = feed.terms
        self.recon_masks = terms.recon_masks
        noise_gen = inputs.generator(seed, "noise", device)
        self.lr, self.beta = cfg["train"]["lr"], cfg["train"]["beta"]
        self.multi = loop.make_multi_train_step(
            self.model, None if terms.dynamic else terms.masks,
            None if terms.dynamic else terms.lambdas, lr=self.lr,
            generator=noise_gen, device=device,
            recon_support=terms.support() if terms.dynamic else None,
            recon_masks=terms.recon_masks)
        self.betas = torch.full((feed.k,), self.beta, device=device)
        self.device = device

        self.noise_state = noise_gen.get_state()
        self.idxs, self.terms, losses = [], [], []

        def call(k):
            idxs, step_terms = feed.take(k)
            self.idxs.append(idxs.reshape(-1).clone())
            self.terms += (list(zip(step_terms[0].copy(),
                                    step_terms[1].copy()))
                           if step_terms else
                           [(terms.masks, terms.lambdas)] * k)
            if half:
                idxs = idxs[:, :feed.batch // 2]
            losses.extend(self.window(idxs, step_terms).tolist())

        call(1)
        opt = self.multi.optimizer
        grad = {k: float(opt.state[p]["exp_avg"].double().norm())
                / (1.0 - ref_common.ADAM["b1"])
                for k, p in self.model.named_parameters() if p in opt.state}
        log("the first step")
        for _ in range(WARM_CALLS):
            call(feed.k)
            log(f"a call of {feed.k} steps")
        before = {k: v.detach().clone()
                  for k, v in self.model.state_dict().items()}
        call(feed.k)
        log(f"the checked call of {feed.k} steps")
        after = self.model.state_dict()
        self.checked = (len(self.terms) - feed.k, len(self.terms))
        self.prog = {"losses": losses, "grad": grad,
                     "change": _moved(before, after, grad),
                     "stats": _moved(before, after, _bn_stats(after))}
        self.rows = None

    def window(self, idxs, step_terms):
        """One call of the K-step window on its feed: the losses on the
        device."""
        return self.multi(self.data, idxs, self.betas[:idxs.shape[0]],
                          **_terms_kw(step_terms, self.device))

    def free(self):
        """The check's rows gathered, in step order; the program freed."""
        at = torch.cat(self.idxs)
        self.rows = {k: v.index_select(0, at) for k, v in self.data.items()}
        del self.multi, self.model, self.data, self.feed
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, cfg, seed, precision="float32"):
        return reference_steps(cfg, seed, self.device, self.rows, self.terms,
                               self.noise_state, self.lr, self.beta,
                               self.checked, precision, self.recon_masks)


def run(ctx):
    cfg, device = ctx.cfg, ctx.device
    prog = Program(cfg, ctx.traffic, ctx.seed, device, log=ctx.log)
    feed = prog.feed
    ctx.setup_done()

    # the window
    enqueue, windows, failed = [], 0, 0
    first_step = feed.step
    t0 = time.perf_counter()
    while True:
        idxs, step_terms = feed.take(feed.k)
        ta = time.perf_counter()
        losses = prog.window(idxs, step_terms)
        enqueue.append(time.perf_counter() - ta)
        vals = losses.tolist()
        failed += sum(not np.isfinite(v) for v in vals)
        windows += 1
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    seconds = time.perf_counter() - t0
    steps = windows * feed.k
    flops = sum(train_step_flops(cfg, feed.batch, w)
                for w in feed.weights[first_step:first_step + steps])
    window = {"seconds": seconds, "units": steps, "flops": flops,
              "peak": PEAK_FLOPS[cfg["compute_dtype"]["train"]],
              "enqueue_ms": [1e3 * e / feed.k for e in enqueue]}
    metrics = {"train_samples_per_s": steps * feed.batch / seconds}

    traced = None
    if ctx.trace:
        def traced_windows():
            for _ in range(TRACED_WINDOWS):
                prog.window(*feed.take(feed.k)).tolist()
        with port_calls.recording() as rec:
            traced = trace.capture(traced_windows, device, port_calls.SPAN,
                                   ctx.log)
        traced["calls"] = rec.calls
        traced["units"] = TRACED_WINDOWS * feed.k
        traced["unit"] = "step"

    ctx.read_memory()
    prog.free()
    numbers = checks.train_numbers(prog.prog, prog.reference(cfg, ctx.seed))
    return {"attempted": steps, "failed": failed, "metrics": metrics,
            "window": window, "traced": traced, "numbers": numbers}


def as_float(cfg, rows, precision="float32"):
    """The reference's float32 inputs: pixels / 255, bits as they are; in
    a lower precision of the control (common.QUANTS), the pixels held in
    it, as the program holds its inputs in its compute dtype."""
    out = {k: v.float() / 255 if cfg["inputs"][k]["kind"] == "pixels"
           else v.float() for k, v in rows.items()}
    quant = ref_common.QUANTS.get(precision)
    if quant is not None:
        out = {k: quant(v) if cfg["inputs"][k]["kind"] == "pixels" else v
               for k, v in out.items()}
    return out


def step_noise(cfg, gen, n_terms, batch, device):
    """One step's noise as the program draws it from the same generator:
    eps (T, B, L), then the encoder dropout's keep-mask in one draw:
    (B, width) where one expert's encoder holds a dropout, (E, B, width),
    a row an encoder in expert order, where E > 1 do."""
    eps = torch.randn((n_terms, batch, cfg["n_latents"]), generator=gen,
                      device=device)
    spec = inputs.keep_spec(cfg)
    keep = None
    if spec is not None:
        encoders, width, rate = spec
        shape = (batch, width) if encoders == 1 else (encoders, batch, width)
        keep = torch.rand(shape, generator=gen, device=device) < 1.0 - rate
    return eps, keep


def reference_steps(cfg, seed, device, rows, check_terms, noise_state, lr,
                    beta, checked, precision="float32", recon_masks=None):
    """The plain reference through every step of the check
    (common.train_steps) from the seed's weights, on the rows the program
    trained on, with its terms (and the configuration's recon_masks, or
    None) and its noise: the numbers of checks.train_numbers; checked:
    the (first, end) steps of the checked call, whose change is read."""
    fam = importlib.import_module(f"reference.{cfg['reference']}")
    model = fam.Model(cfg)
    params = inputs.make_weights(cfg, seed, device)
    gen = torch.Generator(device=device)
    gen.set_state(noise_state)
    batch = next(iter(rows.values())).shape[0] // len(check_terms)
    recon = (None if recon_masks is None
             else torch.as_tensor(recon_masks, device=device))
    first, end = checked
    assert end == len(check_terms)

    def steps():
        for n, (ms, ls) in enumerate(check_terms):
            x = as_float(cfg, {k: v[n * batch:(n + 1) * batch]
                               for k, v in rows.items()}, precision)
            eps, keep = step_noise(cfg, gen, ms.shape[0], batch, device)
            yield (x, torch.as_tensor(np.asarray(ms), device=device),
                   torch.as_tensor(np.asarray(ls), device=device), eps, keep,
                   recon)

    ops = ref_common.Ops(None if precision == "float32" else precision)
    with ref_common.no_tf32():
        losses, grads, before = ref_common.train_steps(
            model, params, ops, steps(), lr, beta, keep_after=first)
    grad = checks.leaf_norms(grads)
    return {"losses": losses, "grad": grad,
            "change": _moved(before, params, grad),
            "stats": _moved(before, params, _bn_stats(params))}
