"""MultiMNIST shard generation of the port (counterpart of
experiments/multimnist/datasets.py; the reference's flags,
multimnist/datasets.py:293-311):

    python -m mvae_tpu_torch.experiments.multimnist.datasets \
        [--n-train 60000] [--n-test 10000] [--fixed] ... [--data-dir ./data]

Writes <data-dir>/multimnist/{training,test}.npz from the MNIST digits
under <data-dir>/MNIST/raw (or the synthetic fallback), bit-identical to
the JAX package's CLI on the same host: the random variant through the
native compositor where its library builds (data/native.py; the 60k/10k
canonical rows in seconds), the fixed variant and a host without g++
through the numpy generator.
"""

import argparse

from mvae_tpu_torch.data.multimnist import make_dataset


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Composite MultiMNIST shards: the native C++ "
                    "compositor where g++ is on PATH (the canonical 60k/10k "
                    "rows in seconds), else the numpy generator (long at "
                    "those sizes); --fixed always takes numpy.")
    p.add_argument('--min-digits', type=int, default=0)
    p.add_argument('--max-digits', type=int, default=4)
    p.add_argument('--no-resize', action='store_true', default=False)
    p.add_argument('--no-translate', action='store_true', default=False)
    p.add_argument('--fixed', action='store_true', default=False)
    p.add_argument('--scramble', action='store_true', default=False)
    p.add_argument('--reverse', action='store_true', default=False)
    p.add_argument('--no-repeat', action='store_true', default=False)
    p.add_argument('--data-dir', type=str, default='./data')
    p.add_argument('--n-train', type=int, default=60000,
                   help='training rows [default: 60000; long on the '
                        'numpy generator]')
    p.add_argument('--n-test', type=int, default=10000)
    args = p.parse_args(argv)
    out = make_dataset(
        args.data_dir, n_train=args.n_train, n_test=args.n_test,
        min_digits=args.min_digits, max_digits=args.max_digits,
        resize=not args.no_resize, translate=not args.no_translate,
        fixed=args.fixed, scramble=args.scramble, reverse=args.reverse,
        no_repeat=args.no_repeat)
    print(f"wrote multimnist shards to {out}")
    return out


if __name__ == "__main__":
    main()
