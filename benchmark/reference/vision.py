"""Plain reference of the Vision MVAE (Wu & Goodman 2018, arXiv:1802.05335,
the case study of computer-vision transformations; mhw32/multimodal-vae-
public, vision/model.py:12-196 and vision/train.py:20-283): six 64x64
image modalities of one face, one expert each,

    m          image  gray  edge  mask  obscured  watermark
    channels   3      1     1     1     3         3

and for each m with C channels:

    {m}_encoder.features     conv C->32->64->128->256 (4,2,1 three times,
                             then 4,1,0; no bias), BatchNorm from the
                             second conv, swish: 64 -> 32 -> 16 -> 8 -> 5
    {m}_encoder.classifier   fc 6400 -> 512, swish, dropout 0.1, fc -> 2L
    {m}_decoder.upsample     fc L -> 6400, swish
    {m}_decoder.hallucinate  convT 256->128->64->32->C (4,1,0, then 4,2,1
                             three times; no bias), BatchNorm + swish
                             between, logits

with L = 250, swish(x) = x sigmoid(x). The posterior of a subset S of the
modalities is the product of its experts and the N(0, I) prior,

    T_m = 1 / (exp(logvar_m) + eps),   T_0 = 1 / (1 + eps),   eps = 1e-8
    var = 1 / (T_0 + sum_{m in S} T_m),   mu = var sum_{m in S} mu_m T_m

and z = mu + sqrt(var) e with e ~ N(0, I). The objective of one step
(vision/train.py) has seven terms, the joint S (all six) and each single
modality, and every term decodes all six modalities from its z:

    loss = sum over the 7 terms of mean over the rows of
           ( sum over the 6 modalities of BCE(decoder_m(z), x_m) / 6
             + beta KL(q(z | x_S) || N(0, I)) )

BCE being the sum over a modality's pixels of the binary cross entropy
with logits, KL the closed form of two Gaussians. Pixels are scaled to
[0, 1]; the edge and mask modalities are 0/1. The configuration states all
this as data (terms.masks: the joint row and the six unit rows;
terms.recon_masks all ones; terms.lambdas all 1/6): the layers, the PoE,
the terms' losses and Adam are celeba.py's and common.py's, so the model
is CelebA's with six image experts. In train mode each encoder runs once
a step, its BatchNorms committing once for each term that holds it (the
joint and its own: twice), and each decoder once a term (seven times).

Departures from the published code, which cannot run as published
(SURVEY.md section 2.6); the reference follows the intended semantics:
- vision/model.py:191-192 add eps twice in the PoE (var + eps, then 1 /
  (var + eps)); the reference adds it once, as the CelebA, CelebA-19 and
  MultiMNIST models do, and as the port does.
- vision/train.py:242 passes joint_logvar where gray_logvar is meant in
  the gray-only term; the reference takes the gray posterior's.
- vision/model.py:32 has a stray backtick (the module does not import);
  vision/model.py:56-57 return an undefined rotated_recon and drop
  watermark_recon: the reference decodes all six modalities.
- vision/train.py:20-21 name the sixth modality rotated where :48 uses
  watermark: the reference's sixth is watermark.
- vision/train.py:139,143 (an unimported datasets), :156-157 (rotated
  unpacked, watermark used), :302 (an unimported tqdm), :324 (a stray
  batch-size argument) and :327 (an undefined loss_function) fail before
  a step; vision/datasets.py:75,79,90 build the inputs (the watermark of
  the obscured image, an undefined grayscale_image). The reference takes
  its inputs from the benchmark's rows and is not touched by them.

Nothing here imports the program under test.
"""

from reference.celeba import Model  # noqa: F401
