"""MultiMNIST MVAE: 50x50 image (DCGAN CNN with BN) + a digit string of up
to 4 characters (GRU). Counterpart of mvae_tpu/models/multimnist.py, with
the reference's module names (multimnist/model.py:75-235), so a
reference-layout `state_dict` loads with `strict=True`:

    image_encoder.features    conv 1->32->64->128->256 (4,2,1 x3; 4,2,0),
                              BN from the 2nd conv, swish: 50->25->12->6->2
    image_encoder.classifier  fc 256*2*2 -> 512 -> swish -> dropout -> 2L
    image_decoder.upsample    fc L -> 256*2*2 -> swish
    image_decoder.hallucinate convT 256->128 (4,2,0), 128->64 (4,2,1),
                              64->32 (5,2,1), 32->1 (4,2,1), BN + swish
                              between: 2->6->12->25->50
    text_encoder              embed Embedding(12, 200); gru, a 1-layer
                              bidirectional GRU(200); h2p 200 -> 2L
    text_decoder              embed Embedding(12, 200); z2h L -> 200;
                              gru, a 2-layer GRU(200 + L -> 200);
                              h2o 200 + L -> 12

The text encoder takes the bi-GRU's last output step and sums its two
directions (:179). The text decoder starts both layers from z2h(z) and
runs 4 steps from SOS: swish(embed(prev)) ‖ z -> layer 1 -> dropout(0.1)
in train mode -> layer 2 -> [h2 ‖ z] -> h2o, and feeds back the argmax of
the step's log-softmax (no teacher forcing). Logits (N, 4, 12).

Mixed precision as in the JAX package: the compute dtype (bfloat16) covers
the conv stacks and the image head; the GRU text nets, BN statistics,
posteriors and the eval-mode logits stay f32. Train mode (`model.train()`):
BN with batch statistics fused with its swish, the image head's dropout
keep-mask and the text decoder's per-step keep-masks (4, N, 200) from the
caller (JAX draws the latter from fold_in(term key, step), :131-133).
With `conv_moments=True` the encoder's conv3 (12x12 input, 4/2/1), the one
BN'd conv the fused op takes, runs fused in train mode; conv2's 25x25
input and conv4's padding 0 keep the unfused route.
"""

import torch
from torch import nn

from mvae_tpu_torch.core.losses import bce_row_sum, cross_entropy_with_logits
from mvae_tpu_torch.data.text import MAX_LENGTH, N_CHARACTERS, SOS
from mvae_tpu_torch.device import resolve_device
from mvae_tpu_torch.models.base import MultimodalVAE, head_chain
from mvae_tpu_torch.models.celeba import ImageDecoder, ImageEncoder
from mvae_tpu_torch.nn.initializers import init_parameters_
from mvae_tpu_torch.nn.layers import Embedding, Linear, dropout, swish
from mvae_tpu_torch.nn.norm import pop_moments, set_bn_groups
from mvae_tpu_torch.nn.rnn import GRU, bigru_last_step, gru_cell

ENC_SPECS = [(32, 4, 2, 1, False), (64, 4, 2, 1, True),
             (128, 4, 2, 1, True), (256, 4, 2, 0, True)]   # 50->25->12->6->2
DEC_SPECS = [(128, 4, 2, 0, True), (64, 4, 2, 1, True),
             (32, 5, 2, 1, True), (1, 4, 2, 1, False)]     # 2->6->12->25->50
H = 200                     # GRU hidden size
TEXT_DROPOUT = 0.1          # between the decoder's GRU layers


class TextEncoder(nn.Module):
    def __init__(self, n_latents, device):
        super().__init__()
        self.embed = Embedding(N_CHARACTERS, H, device=device)
        self.gru = GRU(H, H, 1, bidirectional=True, device=device)
        self.h2p = Linear(H, 2 * n_latents, device=device)

    def forward(self, text):                # (B, 4) int -> (B, 2L) f32
        xs = self.embed(text).transpose(0, 1)               # (4, B, H)
        h_f, h_b = bigru_last_step(self.gru.cell(0), self.gru.cell(0, True),
                                   xs)
        return self.h2p(h_f + h_b)


class TextDecoder(nn.Module):
    def __init__(self, n_latents, device):
        super().__init__()
        self.embed = Embedding(N_CHARACTERS, H, device=device)
        self.z2h = Linear(n_latents, H, device=device)
        self.gru = GRU(H + n_latents, H, 2, device=device)
        self.h2o = Linear(H + n_latents, N_CHARACTERS, device=device)

    def forward(self, z, keep_masks=None):
        """z: (N, L) f32; keep_masks: (4, N, H) bool, the dropout's at each
        step, in train mode -> logits (N, 4, 12) f32."""
        if self.training and keep_masks is None:
            raise ValueError("the train-mode text decoder takes its dropout "
                             "keep-masks from the caller")
        h1 = h2 = self.z2h(z)
        prev = torch.full((z.shape[0],), SOS, dtype=torch.long,
                          device=z.device)
        cell1, cell2 = self.gru.cell(0), self.gru.cell(1)
        outs = []
        for t in range(MAX_LENGTH):
            c_in = torch.cat([swish(self.embed(prev)), z], dim=-1)
            h1 = gru_cell(cell1, c_in, h1)
            x12 = (dropout(h1, keep_masks[t], TEXT_DROPOUT) if self.training
                   else h1)
            h2 = gru_cell(cell2, x12, h2)
            out = self.h2o(torch.cat([h2, z], dim=-1))
            prev = torch.argmax(torch.log_softmax(out, dim=-1), dim=-1)
            outs.append(out)
        return torch.stack(outs, dim=1)


class MultiMnistMVAE(MultimodalVAE):
    modalities = ("image", "text")

    def __init__(self, n_latents: int = 64, compute_dtype=None, *,
                 conv_moments: bool = False, device=None, generator=None):
        """device: None runs on the CUDA card (raises without one), "cpu"
        on the CPU. generator: CPU torch.Generator for the initial weights
        (default: seed 0). conv_moments: the encoder's fused conv + BN
        moments route in train mode (off by default). The model starts in
        eval mode."""
        super().__init__()
        device = resolve_device(device)
        self.n_latents = n_latents
        self.compute_dtype = compute_dtype
        L = n_latents
        self.image_encoder = ImageEncoder(L, compute_dtype, conv_moments,
                                          device, channels=1,
                                          specs=ENC_SPECS, side=2)
        self.image_decoder = ImageDecoder(L, compute_dtype, device,
                                          specs=DEC_SPECS, side=2)
        self.text_encoder = TextEncoder(L, device)
        self.text_decoder = TextDecoder(L, device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        init_parameters_(self, generator)
        self.eval()

    def input_spec(self):
        return {"image": ((50, 50, 1), torch.float32),
                "text": ((MAX_LENGTH,), torch.int32)}

    @property
    def dropout_rate(self) -> float:
        return self.image_encoder.classifier[2].p

    def tp_chains(self):
        return [head_chain("image_encoder")]

    def keep_mask_shape(self, batch: int):
        return (batch, self.image_encoder.classifier.hidden)

    decode_dropout_rate = TEXT_DROPOUT

    def decode_keep_mask_shape(self, rows: int):
        """The text decoder's keep-masks for `rows` decoded rows."""
        return (MAX_LENGTH, rows, H)

    def encode(self, inputs, keep_mask=None):
        L = self.n_latents
        img = self.image_encoder(inputs["image"].permute(0, 3, 1, 2),
                                 keep_mask)
        txt = self.text_encoder(inputs["text"])
        mu = torch.stack([img[:, :L], txt[:, :L]])
        logvar = torch.stack([img[:, L:], txt[:, L:]])
        return mu, logvar, {"image": pop_moments(self.image_encoder),
                            "text": []}

    def decode(self, z, groups: int = 1, keep_mask=None):
        """keep_mask: the text decoder's (4, N, H) keep-masks, in train
        mode."""
        set_bn_groups(self.image_decoder, groups)
        img = self.image_decoder(z).permute(0, 2, 3, 1)
        recons = {"image": img, "text": self.text_decoder(z, keep_mask)}
        return recons, pop_moments(self.image_decoder)

    def recon_loss(self, name, logits, target):
        if name == "image":
            return bce_row_sum(logits.reshape(logits.shape[0], -1),
                               target.reshape(target.shape[0], -1))
        # CE at each of the 4 positions, summed (multimnist/train.py:54-61);
        # row r's positions read target row r mod Nt
        n = logits.shape[0]
        return cross_entropy_with_logits(
            logits.reshape(n * MAX_LENGTH, N_CHARACTERS),
            target.reshape(-1)).reshape(n, MAX_LENGTH).sum(-1)
