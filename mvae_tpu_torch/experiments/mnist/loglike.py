"""MNIST marginal log-likelihood of the port (counterpart of
experiments/mnist/loglike.py; IWAE with q(z|x,y) as the proposal,
core/loglike.py):

    python -m mvae_tpu_torch.experiments.mnist.loglike model_best.pth.tar \
        [--target image|text|joint] [--n-samples 100] [--device cpu]
"""

from mvae_tpu_torch.data.mnist import load_mnist
from mvae_tpu_torch.models.mnist import MnistMVAE
from mvae_tpu_torch.train.loglike_cli import run_loglike


def main(argv=None):
    return run_loglike(argv, MnistMVAE,
                       lambda a: load_mnist(a.data_dir, train=False))


if __name__ == "__main__":
    main()
