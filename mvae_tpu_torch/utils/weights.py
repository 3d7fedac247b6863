"""Weight carry-across: JAX-package pytrees and reference `.pth.tar` files
into the port's reference-layout `state_dict`.

`state_dict_from_jax(family, ...)` is the port's own copy of the
exporters of the ported families in mvae_tpu/utils/torch_export.py
(:31-153, 182-209): Linear weights transpose to (out, in), HWIO conv
kernels become OIHW (the transposed conv's stored (k, k, c_out, c_in)
becomes torch's (c_in, c_out, k, k)), the fc layers that feed or follow a
`view(-1, C, H, W)` permute between the JAX package's (h, w, c) order and
torch's (c, h, w) order, MNIST's single 2L heads split into the
reference's fc31 / fc32, and embedding tables keep their layout.
"""

import numpy as np
import torch

from mvae_tpu_torch.device import resolve_device


def _np(v):
    return np.ascontiguousarray(np.asarray(v, dtype=np.float32))


def _x_lin(sd, p, lin):
    sd[p + ".weight"] = _np(lin["w"]).T.copy()
    sd[p + ".bias"] = _np(lin["b"])


def _x_lin_cat(sd, p_mu, p_lv, lin):
    """A single 2L head [mu | logvar] -> two L-wide torch heads."""
    w, b = _np(lin["w"]), _np(lin["b"])
    L = w.shape[1] // 2
    sd[p_mu + ".weight"] = w[:, :L].T.copy()
    sd[p_mu + ".bias"] = b[:L].copy()
    sd[p_lv + ".weight"] = w[:, L:].T.copy()
    sd[p_lv + ".bias"] = b[L:].copy()


def _x_lin_up(sd, p, c, h, w, lin):
    """(h, w, c)-ordered output columns -> torch's view(B, c, h, w) order."""
    W = _np(lin["w"])                                   # (in, h*w*c)
    W = W.reshape(-1, h, w, c).transpose(0, 3, 1, 2).reshape(W.shape[0], -1)
    sd[p + ".weight"] = W.T.copy()
    b = _np(lin["b"]).reshape(h, w, c).transpose(2, 0, 1).reshape(-1)
    sd[p + ".bias"] = b.copy()


def _x_lin_flat(sd, p, c, h, w, lin):
    """(h, w, c)-ordered input rows -> torch's x.flatten(1) of (B, c, h, w)."""
    W = _np(lin["w"])                                   # (h*w*c, out)
    W = W.reshape(h, w, c, -1).transpose(2, 0, 1, 3).reshape(c * h * w, -1)
    sd[p + ".weight"] = W.T.copy()
    sd[p + ".bias"] = _np(lin["b"])


def _x_conv(sd, p, conv):
    sd[p + ".weight"] = _np(conv["w"]).transpose(3, 2, 0, 1).copy()


def _x_convT(sd, p, conv):
    sd[p + ".weight"] = _np(conv["w"]).transpose(3, 2, 0, 1).copy()


def _x_bn(sd, p, bn_params, bn_state):
    sd[p + ".weight"] = _np(bn_params["scale"])
    sd[p + ".bias"] = _np(bn_params["bias"])
    sd[p + ".running_mean"] = _np(bn_state["mean"])
    sd[p + ".running_var"] = _np(bn_state["var"])
    sd[p + ".num_batches_tracked"] = np.asarray(0, dtype=np.int64)


def _x_embed(sd, p, emb):
    sd[p + ".weight"] = _np(emb["table"])


def _x_dcgan_enc(sd, mod, conv_ix, bn_ix, params, state):
    for j, ci in enumerate(conv_ix):
        _x_conv(sd, f"{mod}.features.{ci}", params[j]["conv"])
        if 0 < j <= len(bn_ix):
            _x_bn(sd, f"{mod}.features.{bn_ix[j - 1]}",
                  params[j]["bn"], state[j])


def _x_dcgan_dec(sd, mod, conv_ix, bn_ix, params, state):
    for j, ci in enumerate(conv_ix):
        _x_convT(sd, f"{mod}.hallucinate.{ci}", params[j]["conv"])
        if j < len(bn_ix):
            _x_bn(sd, f"{mod}.hallucinate.{bn_ix[j]}",
                  params[j]["bn"], state[j])


def _x_celeba_image_side(sd, params, state):
    enc = params["image_enc"]
    _x_dcgan_enc(sd, "image_encoder", (0, 2, 5, 8), (3, 6, 9),
                 enc["conv"], state["enc"]["image"])
    _x_lin_flat(sd, "image_encoder.classifier.0", 256, 5, 5,
                enc["head"]["fc"])
    _x_lin(sd, "image_encoder.classifier.3", enc["head"]["out"])
    dec = params["image_dec"]
    _x_lin_up(sd, "image_decoder.upsample.0", 256, 5, 5, dec["up"])
    _x_dcgan_dec(sd, "image_decoder", (0, 3, 6, 9), (1, 4, 7),
                 dec["deconv"], state["dec"]["image"])


def _x_mlp_bn(sd, mod, lin_ix, bn_ix, head_ix, mlp, state):
    for j, (li, bi) in enumerate(zip(lin_ix, bn_ix)):
        _x_lin(sd, f"{mod}.{li}", mlp["blocks"][j]["fc"])
        _x_bn(sd, f"{mod}.{bi}", mlp["blocks"][j]["bn"], state[j])
    _x_lin(sd, f"{mod}.{head_ix}", mlp["head"])


def _export_celeba(params, state):
    sd = {}
    _x_celeba_image_side(sd, params, state)
    _x_mlp_bn(sd, "attrs_encoder.net", (0, 3), (1, 4), 6,
              params["attrs_enc"], state["enc"]["attrs"])
    _x_mlp_bn(sd, "attrs_decoder.net", (0, 3, 6), (1, 4, 7), 9,
              params["attrs_dec"], state["dec"]["attrs"])
    return sd


def _export_mnist(params, state):
    sd = {}
    for i, lin in enumerate(params["image_enc"][:2]):
        _x_lin(sd, f"image_encoder.fc{i + 1}", lin)
    _x_lin_cat(sd, "image_encoder.fc31", "image_encoder.fc32",
               params["image_enc"][2])
    for i, lin in enumerate(params["image_dec"]):
        _x_lin(sd, f"image_decoder.fc{i + 1}", lin)
    _x_embed(sd, "text_encoder.fc1", params["text_enc"]["embed"])
    _x_lin(sd, "text_encoder.fc2", params["text_enc"]["fc"])
    _x_lin_cat(sd, "text_encoder.fc31", "text_encoder.fc32",
               params["text_enc"]["head"])
    for i, lin in enumerate(params["text_dec"]):
        _x_lin(sd, f"text_decoder.fc{i + 1}", lin)
    return sd


def _export_fashionmnist(params, state):
    sd = {}
    enc = params["image_enc"]
    for j, ci in enumerate((0, 2)):
        _x_conv(sd, f"image_encoder.features.{ci}", enc["conv"][j]["conv"])
    _x_lin_flat(sd, "image_encoder.classifier.0", 128, 7, 7, enc["fc"])
    _x_lin(sd, "image_encoder.classifier.2", enc["head"])
    dec = params["image_dec"]
    _x_lin(sd, "image_decoder.upsampler.0", dec["up"][0])
    _x_lin_up(sd, "image_decoder.upsampler.2", 128, 7, 7, dec["up"][1])
    for j, ci in enumerate((0, 2)):
        _x_convT(sd, f"image_decoder.hallucinate.{ci}",
                 dec["deconv"][j]["conv"])
    _x_embed(sd, "text_encoder.net.0", params["text_enc"]["embed"])
    _x_lin(sd, "text_encoder.net.2", params["text_enc"]["fc"])
    _x_lin(sd, "text_encoder.net.4", params["text_enc"]["head"])
    for i, ix in enumerate((0, 2, 4, 6)):
        _x_lin(sd, f"text_decoder.net.{ix}", params["text_dec"][i])
    return sd


EXPORTERS = {"mnist": _export_mnist, "fashionmnist": _export_fashionmnist,
             "celeba": _export_celeba}


def state_dict_from_jax(family, params, state):
    """A family's (params, state) of the JAX package, as nested dicts and
    lists of numpy arrays -> the reference `state_dict` of numpy arrays
    (f32, `num_batches_tracked` int64 0), as
    mvae_tpu/utils/torch_export.py:export_state_dict(family, ...) gives."""
    if family not in EXPORTERS:
        raise ValueError(f"unknown or unported family {family!r} (choose "
                         f"from {sorted(EXPORTERS)})")
    return EXPORTERS[family](params, state)


def checkpoint_family(state_dict, meta) -> str:
    """The family of a reference-layout checkpoint: its meta's "model"
    (the port's and the JAX package's own files name it), else the family
    whose keys the state_dict holds (the reference's files carry no name)."""
    if "model" in meta:
        return meta["model"]
    for family, key in (("celeba", "attrs_encoder.net.0.weight"),
                        ("fashionmnist", "text_encoder.net.0.weight"),
                        ("mnist", "text_encoder.fc1.weight")):
        if key in state_dict:
            return family
    raise ValueError("the checkpoint names no model and its keys match no "
                     "ported family")


def _numpy_scalar_globals():
    """What `torch.load(weights_only=True)` needs to read numpy scalars
    (a checkpoint's `best_loss` may be one)."""
    core = getattr(np, "_core", None) or np.core
    return [core.multiarray.scalar, np.dtype, np.dtypes.Float64DType,
            np.dtypes.Float32DType]


def load_reference_checkpoint(path, *, device=None):
    """Read a reference-layout `.pth.tar` ({'state_dict', 'n_latents',
    'best_loss', 'optimizer'}, and 'model' where the file names its
    family) with `weights_only=True`.

    device: None puts the tensors on the CUDA card (raises without one),
    "cpu" on the CPU. Returns (state_dict of tensors, meta);
    checkpoint_family(state_dict, meta) names the family."""
    device = resolve_device(device)
    with torch.serialization.safe_globals(_numpy_scalar_globals()):
        ckpt = torch.load(path, map_location=device, weights_only=True)
    sd = ckpt.get("state_dict", ckpt)
    meta = {k: v for k, v in ckpt.items()
            if k not in ("state_dict", "optimizer")}
    return sd, meta
