"""FashionMNIST marginal log-likelihood of the port (counterpart of
experiments/fashionmnist/loglike.py; IWAE, core/loglike.py):

    python -m mvae_tpu_torch.experiments.fashionmnist.loglike \
        model_best.pth.tar [--target image|text|joint] [--device cpu]
"""

from mvae_tpu_torch.data.mnist import load_mnist
from mvae_tpu_torch.models.fashionmnist import FashionMnistMVAE
from mvae_tpu_torch.train.loglike_cli import run_loglike


def main(argv=None):
    return run_loglike(
        argv, FashionMnistMVAE,
        lambda a: load_mnist(a.data_dir, train=False, variant="FashionMNIST",
                             flatten=False))


if __name__ == "__main__":
    main()
