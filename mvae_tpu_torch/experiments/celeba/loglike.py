"""CelebA marginal log-likelihood of the port (counterpart of
experiments/celeba/loglike.py; IWAE, core/loglike.py) on the test
partition:

    python -m mvae_tpu_torch.experiments.celeba.loglike model_best.pth.tar \
        [--target image|attrs|joint] [--n-samples 100] [--device cpu]
"""

from mvae_tpu_torch.data.celeba import load_celeba
from mvae_tpu_torch.models.celeba import CelebaMVAE
from mvae_tpu_torch.train.loglike_cli import run_loglike


def main(argv=None):
    return run_loglike(argv, CelebaMVAE,
                       lambda a: load_celeba(a.data_dir, 'test'))


if __name__ == "__main__":
    main()
