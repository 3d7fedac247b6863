"""PyTorch / CUDA port of mvae_tpu for one NVIDIA Hopper card (H100).

The JAX package `mvae_tpu` is the reference; this package imports nothing
of it, keeps its module layout and names, and holds each of its Pallas
kernels as a CUDA kernel written by hand (`ops/`, `csrc/`). Entry points
run on the CUDA card unless the caller passes `device="cpu"` (`device.py`).

Ported: all six families, CelebA, MNIST, FashionMNIST, MultiMNIST,
CelebA-19 and vision (`models/`; the GRU of MultiMNIST's text in
`nn/rnn.py`, CelebA-19's sampled subset terms in `core/subsets.py`,
vision's image transforms in `image/`),
the multi-term ELBO in eval and train mode (`train.loop.make_eval_step`;
`make_train_step` and `make_multi_train_step` with Adam and the BN
running-statistics commit), the IWAE log-likelihood (`core.loglike`), the
serving endpoints (`serve.Sampler`) and their HTTP front with
micro-batching (`serve_http`), the weight carry-across
(`utils.weights`), the MNIST / FashionMNIST downloader (`data.download`),
and each family's train, sample and loglike CLIs
(`python -m mvae_tpu_torch.experiments.<family>.<cli>`), whose training
keeps the dataset on the card or streams it from the host
(`--no-device-data`), on one device or across processes on the JAX
mesh's (data, model) grid (`parallel/`: the train CLIs' --coordinator /
--process-id / --n-processes or --distributed under torchrun; BN
statistics shared across the dp ranks between the BN kernels' passes,
tensor and expert parallelism where the ranks do not divide the batch),
and serving over a data-parallel group (`Sampler(dp=)`, `serve_http
--dp`).
"""

__version__ = "0.1.0"
