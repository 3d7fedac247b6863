"""FashionMNIST MVAE training CLI of the port (counterpart of
experiments/fashionmnist/train.py; the reference's flags,
fashionmnist/train.py:132-154, the MNIST CLI's defaults and schedule).

    python -m mvae_tpu_torch.experiments.fashionmnist.train [--device cpu]

Reads the FashionMNIST IDX files under --data-dir/FashionMNIST/raw, or
the synthetic set without them; images (N, 28, 28, 1).
"""

from mvae_tpu_torch.experiments.mnist import train as mnist_train
from mvae_tpu_torch.models.fashionmnist import FashionMnistMVAE

TERM_MASKS = mnist_train.TERM_MASKS
parser = mnist_train.parser


def main(argv=None):
    return mnist_train.main(argv, model_class=FashionMnistMVAE,
                            family="fashionmnist", variant="FashionMNIST",
                            flatten=False)


if __name__ == "__main__":
    main()
