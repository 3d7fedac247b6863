"""MultiMNIST marginal log-likelihood of the port (counterpart of
experiments/multimnist/loglike.py; IWAE, core/loglike.py) on the test
shard:

    python -m mvae_tpu_torch.experiments.multimnist.loglike \
        model_best.pth.tar [--target image|text|joint] [--n-samples 100] \
        [--device cpu]
"""

from mvae_tpu_torch.data.multimnist import load_multimnist
from mvae_tpu_torch.models.multimnist import MultiMnistMVAE
from mvae_tpu_torch.train.loglike_cli import run_loglike


def main(argv=None):
    return run_loglike(argv, MultiMnistMVAE,
                       lambda a: load_multimnist(a.data_dir, train=False))


if __name__ == "__main__":
    main()
