"""Model families of the port (CelebA so far)."""

from mvae_tpu_torch.models.celeba import CelebaMVAE

__all__ = ["CelebaMVAE"]
