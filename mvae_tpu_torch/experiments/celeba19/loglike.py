"""CelebA-19 marginal log-likelihood of the port (counterpart of
experiments/celeba19/loglike.py; IWAE, core/loglike.py) on the test
partition; the joint target sums the image's and the 18 attributes'
losses (the model's loglike_targets):

    python -m mvae_tpu_torch.experiments.celeba19.loglike \
        model_best.pth.tar [--target image|attrs|joint] [--n-samples 100] \
        [--device cpu]
"""

from mvae_tpu_torch.data.celeba import load_celeba
from mvae_tpu_torch.models.celeba19 import Celeba19MVAE
from mvae_tpu_torch.train.loglike_cli import run_loglike


def main(argv=None):
    return run_loglike(argv, Celeba19MVAE,
                       lambda a: load_celeba(a.data_dir, 'test'))


if __name__ == "__main__":
    main()
