"""Model families of the port (counterpart of mvae_tpu/models/__init__.py,
for the families ported so far)."""

from mvae_tpu_torch.models.celeba import CelebaMVAE
from mvae_tpu_torch.models.fashionmnist import FashionMnistMVAE
from mvae_tpu_torch.models.mnist import MnistMVAE

FAMILIES = {"mnist": MnistMVAE, "fashionmnist": FashionMnistMVAE,
            "celeba": CelebaMVAE}


def model_ctor(family: str):
    if family not in FAMILIES:
        raise ValueError(f"unknown or unported family {family!r} (choose "
                         f"from {sorted(FAMILIES)})")
    return FAMILIES[family]


__all__ = ["CelebaMVAE", "FAMILIES", "FashionMnistMVAE", "MnistMVAE",
           "model_ctor"]
