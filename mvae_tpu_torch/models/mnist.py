"""MNIST MVAE: 28x28 image (MLP) + digit label. Counterpart of
mvae_tpu/models/mnist.py, with the reference's module names
(mnist/model.py:67-146), so a reference-layout `state_dict` loads with
`strict=True`:

    image_encoder   fc1 784 -> 512, fc2 512 -> 512, swish after each;
                    heads fc31 (mu), fc32 (logvar) 512 -> L
    image_decoder   fc1 L -> 512, fc2, fc3 512 -> 512, swish after each;
                    fc4 512 -> 784 logits
    text_encoder    fc1 Embedding(10, 512) -> swish, fc2 512 -> 512 ->
                    swish; heads fc31, fc32 512 -> L
    text_decoder    fc1 .. fc3 as the image decoder's, fc4 512 -> 10 logits

The two heads run as one 2L matmul, [mu | logvar], the JAX package's single
head (models/mnist.py:56-57). Images are (B, 784) rows in [0, 1], labels
(B,) int.

Mixed precision as in the JAX package: with a compute dtype (bfloat16) the
image rows, the latents and the looked-up label embeddings are rounded to
it (models/mnist.py:54-63, 75), and the label embedding's swish runs in
it; every matmul after that meets an f32 weight, which JAX's type
promotion makes an f32 matmul, so the port upcasts there too. Posteriors
and logits are f32. There is no dropout and no BatchNorm: train mode
needs no keep-mask and leaves no moments.
"""

import torch
from torch import nn

from mvae_tpu_torch.core.losses import bce_row_sum, cross_entropy_with_logits
from mvae_tpu_torch.device import resolve_device
from mvae_tpu_torch.models.base import MultimodalVAE
from mvae_tpu_torch.nn.initializers import init_parameters_
from mvae_tpu_torch.nn.layers import Embedding, Linear, linear, swish

N_CLASSES = 10


def joint_head(h, fc_mu, fc_logvar):
    """The reference's two L-wide heads as one matmul: (N, 2L) f32,
    [mu | logvar]. Under tensor parallelism the two hold the rank's slice
    of the 2L features of [mu | logvar] (parallel/mesh.py: a joint
    layer), which the column layer gathers."""
    w = torch.cat([fc_mu.weight, fc_logvar.weight])
    b = torch.cat([fc_mu.bias, fc_logvar.bias])
    return linear(h, w, b, fc_mu.tp)


class ImageEncoder(nn.Module):
    def __init__(self, n_latents, device):
        super().__init__()
        self.fc1 = Linear(784, 512, device=device)
        self.fc2 = Linear(512, 512, device=device)
        self.fc31 = Linear(512, n_latents, device=device)
        self.fc32 = Linear(512, n_latents, device=device)

    def forward(self, x):                   # x: (N, 784) f32
        h = swish(self.fc2(swish(self.fc1(x))))
        return joint_head(h, self.fc31, self.fc32)


class TextEncoder(nn.Module):
    def __init__(self, n_latents, device):
        super().__init__()
        self.fc1 = Embedding(N_CLASSES, 512, device=device)
        self.fc2 = Linear(512, 512, device=device)
        self.fc31 = Linear(512, n_latents, device=device)
        self.fc32 = Linear(512, n_latents, device=device)

    def forward(self, labels, dtype):
        h = swish(self.fc1(labels).to(dtype))
        h = swish(self.fc2(h.float()))
        return joint_head(h, self.fc31, self.fc32)


class Decoder(nn.Module):
    """fc1 .. fc3 with a swish after each, fc4 to `d_out` logits."""

    def __init__(self, n_latents, d_out, device):
        super().__init__()
        self.fc1 = Linear(n_latents, 512, device=device)
        self.fc2 = Linear(512, 512, device=device)
        self.fc3 = Linear(512, 512, device=device)
        self.fc4 = Linear(512, d_out, device=device)

    def forward(self, z):
        h = swish(self.fc3(swish(self.fc2(swish(self.fc1(z))))))
        return self.fc4(h)


class MnistMVAE(MultimodalVAE):
    modalities = ("image", "text")

    def __init__(self, n_latents: int = 64, compute_dtype=None, *,
                 device=None, generator=None):
        """device: None runs on the CUDA card (raises without one), "cpu"
        on the CPU. generator: CPU torch.Generator for the initial weights
        (default: seed 0). The model starts in eval mode."""
        super().__init__()
        device = resolve_device(device)
        self.n_latents = n_latents
        self.compute_dtype = compute_dtype
        self.image_encoder = ImageEncoder(n_latents, device)
        self.image_decoder = Decoder(n_latents, 784, device)
        self.text_encoder = TextEncoder(n_latents, device)
        self.text_decoder = Decoder(n_latents, N_CLASSES, device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        init_parameters_(self, generator)
        self.eval()

    def input_spec(self):
        return {"image": ((784,), torch.float32), "text": ((), torch.int32)}

    def tp_chains(self):
        """JAX's image_enc, image_dec and text_dec lists; its text_enc is
        lone linears (mvae_tpu/models/mnist.py)."""
        enc = [(f"image_encoder.fc{i}",) for i in (1, 2)] + [
            ("image_encoder.fc31", "image_encoder.fc32")]
        return [enc] + [[(f"{d}.fc{i}",) for i in range(1, 5)]
                        for d in ("image_decoder", "text_decoder")]

    def _rounded(self, x):
        """x rounded to the compute dtype, in f32 (see the docstring)."""
        cd = self.compute_dtype
        return x.float() if cd is None else x.to(cd).float()

    def encode(self, inputs, keep_mask=None):
        L = self.n_latents
        img = inputs["image"]
        img = self.image_encoder(self._rounded(img.reshape(img.shape[0], -1)))
        txt = self.text_encoder(inputs["text"],
                                self.compute_dtype or torch.float32)
        mu = torch.stack([img[:, :L], txt[:, :L]])
        logvar = torch.stack([img[:, L:], txt[:, L:]])
        return mu, logvar, {"image": [], "text": []}

    # both decoders are stateless MLPs: a term that never trains one
    # skips it, exactly (mvae_tpu/models/mnist.py:71)
    exact_skip_groups = ("image", "text")

    def decode_group(self, name, z, groups, terms, keep_mask=None,
                     operand=None):
        return {name: getattr(self, f"{name}_decoder")(self._rounded(z))}, []

    def recon_loss(self, name, logits, target):
        if name == "image":
            return bce_row_sum(logits, target.reshape(target.shape[0], -1))
        return cross_entropy_with_logits(logits, target)
