"""The benchmark's frozen yardstick: the card's published peaks and the
operations a step or a scoring batch needs, counted from the shapes the
configuration file lists (never from the program's own ops).

Peaks (NVIDIA's H100 SXM data sheet, dense, at the card's 700 W limit):
989 TFLOP/s in bf16 on the tensor cores, 67 TFLOP/s in float32 outside
them (TF32 off, as the port's float32 paths run), 3.35 TB/s of HBM3.

Operations, by the rule of the port's tools/measure.py:count_step: 2 a
multiply-add of every convolution and matrix product; a convolution's at
each output position, a transposed one's at each input position; in a
train step each expert's encoder once, each term's decode only of the
modalities its loss weights ((recon_masks, else masks) x lambdas != 0,
inputs.Terms.recon_weights), and in the backward the same count again
for each operand that needs a gradient: every weight, and an activation
wherever a layer upstream of it is trained (a decoder's input z always;
an encoder's first product's input, the data, never). Elementwise work,
the BatchNorms, the losses and the optimizer are not counted; nor are
decodes a term's loss does not weight (the program may run them: they
are not needed).
"""

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12
PEAK_SOURCE = ("NVIDIA H100 SXM data sheet at 700 W: 989 TFLOP/s dense "
               "bf16, 67 TFLOP/s float32 without TF32, 3.35 TB/s HBM3")


def stack_products(stack, shape):
    """The forward multiply-adds a row of each product of a stack, and the
    shape after it: ([(kind, macs), ...], shape); kind is "product" or
    "param" (a layer with parameters and no product: an embedding)."""
    out = []
    for e in stack:
        op = e[0]
        if op == "nchw":
            h, w, c = shape
            shape = (c, h, w)
        elif op == "nhwc":
            c, h, w = shape
            shape = (h, w, c)
        elif op == "flatten":
            n = 1
            for d in shape:
                n *= d
            shape = (n,)
        elif op == "unflatten":
            shape = tuple(e[1:])
        elif op == "conv":
            _, cin, cout, k, s, p = e
            _, h, w = shape
            oh, ow = (h + 2 * p - k) // s + 1, (w + 2 * p - k) // s + 1
            out.append(("product", oh * ow * cout * cin * k * k))
            shape = (cout, oh, ow)
        elif op == "convT":
            _, cin, cout, k, s, p = e
            _, h, w = shape
            out.append(("product", h * w * cin * cout * k * k))
            shape = (cout, (h - 1) * s - 2 * p + k, (w - 1) * s - 2 * p + k)
        elif op == "linear":
            _, din, dout = e
            out.append(("product", din * dout))
            shape = (dout,)
        elif op == "embed":
            out.append(("param", 0))
            shape = (e[2],)
    return out, shape


def expert_costs(cfg):
    """Each expert's (name, encoder forward, encoder forward + backward,
    decoder forward, decoder forward + backward), in operations a row."""
    stacks, latents = cfg["stacks"], cfg["n_latents"]
    out = []
    for e in cfg["experts"]:
        inp = cfg["inputs"]["attrs" if e["name"].startswith("attr_")
                            else e["name"]]["shape"]
        shape = (tuple(inp) if not e["name"].startswith("attr_") else ())
        enc_f = enc_fb = 0
        trained_below = False
        for s in e["encoder"]:
            products, shape = stack_products(stacks[s], shape)
            for kind, macs in products:
                if kind == "param":
                    trained_below = True
                    continue
                enc_f += 2 * macs
                enc_fb += 2 * macs * (2 + trained_below)
                trained_below = True
        shape = (latents,)
        dec_f = 0
        for s in e["decoder"]:
            products, shape = stack_products(stacks[s], shape)
            dec_f += sum(2 * macs for _, macs in products)
        for i in range(e.get("repeat", 1)):
            out.append((e["name"].format(i=i), enc_f, enc_fb, dec_f,
                        3 * dec_f))
    return out


def train_step_flops(cfg, rows, weights):
    """The operations a train step needs at `rows` rows; weights (T, M),
    the step's reconstruction weights (inputs.Terms.recon_weights)."""
    costs = expert_costs(cfg)
    live = [sum(1 for row in weights if row[m] != 0)
            for m in range(len(costs))]
    return rows * sum(c[2] + live[m] * c[4] for m, c in enumerate(costs))


def score_flops(cfg, rows, samples):
    """The operations an IWAE batch needs: the proposal's encoders on the
    rows, the targets' decoders on samples x rows."""
    proposal, targets = cfg["score"]["proposal"], cfg["score"]["targets"]
    total = 0
    for m, (name, enc_f, _, dec_f, _) in enumerate(expert_costs(cfg)):
        if proposal[m]:
            total += rows * enc_f
        if name in targets:
            total += samples * rows * dec_f
    return total
