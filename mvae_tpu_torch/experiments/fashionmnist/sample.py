"""FashionMNIST conditional generation of the port (counterpart of
experiments/fashionmnist/sample.py; fashionmnist/sample.py:50-124): the
MNIST sample CLI's four modes on the FashionMNIST model and test set.

    python -m mvae_tpu_torch.experiments.fashionmnist.sample \
        model_best.pth.tar [--condition-on-image 7] [--device cpu]
"""

from mvae_tpu_torch.experiments.mnist import sample as mnist_sample
from mvae_tpu_torch.models.fashionmnist import FashionMnistMVAE


def main(argv=None):
    return mnist_sample.main(argv, model_class=FashionMnistMVAE,
                             variant="FashionMNIST", flatten=False)


if __name__ == "__main__":
    main()
