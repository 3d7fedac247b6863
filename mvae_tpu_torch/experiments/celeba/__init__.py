"""CelebA: `python -m mvae_tpu_torch.experiments.celeba.train`."""
