"""Vision marginal log-likelihood of the port (counterpart of
experiments/vision/loglike.py; IWAE, core/loglike.py) on the test
partition, its modalities derived on the CLI's device:

    python -m mvae_tpu_torch.experiments.vision.loglike model_best.pth.tar \
        [--target image|gray|edge|mask|obscured|watermark|joint] \
        [--n-samples 100] [--device cpu]
"""

from mvae_tpu_torch.data.vision import load_celeb_vision
from mvae_tpu_torch.models.vision import VisionMVAE
from mvae_tpu_torch.train.loglike_cli import run_loglike


def main(argv=None):
    return run_loglike(argv, VisionMVAE, lambda a: load_celeb_vision(
        a.data_dir, 'test', device=a.device))


if __name__ == "__main__":
    main()
