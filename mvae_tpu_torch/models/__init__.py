"""Model families of the port (counterpart of mvae_tpu/models/__init__.py:
all six families)."""

from mvae_tpu_torch.models.celeba import CelebaMVAE
from mvae_tpu_torch.models.celeba19 import Celeba19MVAE
from mvae_tpu_torch.models.fashionmnist import FashionMnistMVAE
from mvae_tpu_torch.models.mnist import MnistMVAE
from mvae_tpu_torch.models.multimnist import MultiMnistMVAE
from mvae_tpu_torch.models.vision import VisionMVAE

FAMILIES = {"mnist": MnistMVAE, "fashionmnist": FashionMnistMVAE,
            "celeba": CelebaMVAE, "multimnist": MultiMnistMVAE,
            "celeba19": Celeba19MVAE, "vision": VisionMVAE}


def model_ctor(family: str):
    if family not in FAMILIES:
        raise ValueError(f"unknown or unported family {family!r} (choose "
                         f"from {sorted(FAMILIES)})")
    return FAMILIES[family]


__all__ = ["Celeba19MVAE", "CelebaMVAE", "FAMILIES", "FashionMnistMVAE",
           "MnistMVAE", "MultiMnistMVAE", "VisionMVAE", "model_ctor"]
