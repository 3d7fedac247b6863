"""Weight carry-across: JAX-package pytrees and reference `.pth.tar` files
into the port's reference-layout `state_dict`.

`state_dict_from_jax` is the port's own copy of the CelebA exporter in
mvae_tpu/utils/torch_export.py:31-110,182-209: Linear weights transpose to
(out, in), HWIO conv kernels become OIHW (the transposed conv's stored
(k, k, c_out, c_in) becomes torch's (c_in, c_out, k, k)), and the fc layers
that feed or follow a `view(-1, C, H, W)` permute between the JAX
package's (h, w, c) order and torch's (c, h, w) order.
"""

import numpy as np
import torch

from mvae_tpu_torch.device import resolve_device


def _np(v):
    return np.ascontiguousarray(np.asarray(v, dtype=np.float32))


def _x_lin(sd, p, lin):
    sd[p + ".weight"] = _np(lin["w"]).T.copy()
    sd[p + ".bias"] = _np(lin["b"])


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


def state_dict_from_jax(params, state):
    """CelebA (params, state) of the JAX package, as nested dicts and lists
    of numpy arrays -> the reference `state_dict` of numpy arrays (f32,
    `num_batches_tracked` int64 0)."""
    return _export_celeba(params, state)


def _numpy_scalar_globals():
    """What `torch.load(weights_only=True)` needs to read numpy scalars
    (a checkpoint's `best_loss` may be one)."""
    core = getattr(np, "_core", None) or np.core
    return [core.multiarray.scalar, np.dtype, np.dtypes.Float64DType,
            np.dtypes.Float32DType]


def load_reference_checkpoint(path, *, device=None):
    """Read a reference-layout `.pth.tar` ({'state_dict', 'n_latents',
    'best_loss', 'optimizer'}) with `weights_only=True`.

    device: None puts the tensors on the CUDA card (raises without one),
    "cpu" on the CPU. Returns (state_dict of tensors, meta)."""
    device = resolve_device(device)
    with torch.serialization.safe_globals(_numpy_scalar_globals()):
        ckpt = torch.load(path, map_location=device, weights_only=True)
    sd = ckpt.get("state_dict", ckpt)
    meta = {k: v for k, v in ckpt.items()
            if k not in ("state_dict", "optimizer")}
    return sd, meta
