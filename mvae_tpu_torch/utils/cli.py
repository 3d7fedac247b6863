"""The CLIs' argument parsers (counterpart of mvae_tpu/utils/cli.py:7-78):
the reference's flag surface with the JAX package's defaults, without
--cuda (the port runs on the card unless --device says otherwise) and
--exact-decode (it decodes real images with PIL, the exact path, always),
plus --device.

--no-device-data streams the batches from the host (train/driver.py).
The multi-process flags start training across processes
(parallel/distributed.py:maybe_initialize): --coordinator host:port
--process-id i --n-processes N, one process a rank, or a bare
--distributed under torchrun, which sets the ranks in the environment.
Where N does not divide the batch, the leftover factor is tensor and
expert parallelism (parallel/mesh.py), on one node only.
"""

import argparse


def device_flag(p):
    """--device, on every CLI of the port."""
    p.add_argument('--device', type=str, default=None,
                   help='torch device to run on [default: the CUDA card; '
                        'raises without one]; "cpu" runs the plain PyTorch '
                        'versions of the kernels')


def train_parser(*, n_latents, epochs, annealing_epochs, lr, batch_size=100,
                 lambda_flags=(("lambda-image", 1.0), ("lambda-text", 10.0)),
                 bf16_default=False):
    p = argparse.ArgumentParser()
    p.add_argument('--n-latents', type=int, default=n_latents,
                   help=f'size of the latent embedding [default: {n_latents}]')
    p.add_argument('--batch-size', type=int, default=batch_size, metavar='N')
    p.add_argument('--epochs', type=int, default=epochs, metavar='N')
    p.add_argument('--annealing-epochs', type=int, default=annealing_epochs,
                   metavar='N')
    p.add_argument('--lr', type=float, default=lr, metavar='LR')
    p.add_argument('--log-interval', type=int, default=10, metavar='N',
                   help='steps per logging window (one loss readback)')
    for name, default in lambda_flags:
        p.add_argument(f'--{name}', type=float, default=default)
    device_flag(p)
    p.add_argument('--data-dir', type=str, default='./data')
    p.add_argument('--out-dir', type=str, default='./trained_models')
    p.add_argument('--resume', type=str, default=None,
                   help='a checkpoint.pth.tar to resume (or a params-only '
                        '.pth.tar to warm-start from)')
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--profile-dir', type=str, default=None,
                   help='write a torch.profiler trace of the second '
                        'logging window')
    p.add_argument('--bf16', action='store_true', default=bf16_default,
                   help='bfloat16 compute for the conv and expert stacks '
                        '(params, BN statistics and losses stay f32)'
                        + (' [default for this experiment]'
                           if bf16_default else ''))
    p.add_argument('--f32', dest='bf16', action='store_false',
                   help='float32 compute (the reference numerics)')
    p.add_argument('--download', action='store_true', default=False,
                   help='fetch the MNIST / FashionMNIST archives first '
                        '(needs network access; on a failure, go on with '
                        'the local files or the synthetic set); CelebA '
                        'prints where its files go')
    p.add_argument('--no-device-data', action='store_true', default=False,
                   help='stream the batches from the host instead of '
                        'keeping the dataset on the device (the default '
                        'while it fits the driver\'s budget)')
    # multi-process data parallelism: parallel/distributed.py
    p.add_argument('--distributed', action='store_true', default=False,
                   help='torch.distributed with the ranks and the address '
                        'from the environment torchrun sets (RANK, '
                        'WORLD_SIZE, MASTER_ADDR, MASTER_PORT, LOCAL_RANK)')
    p.add_argument('--coordinator', type=str, default=None,
                   help='rank 0\'s host:port for an explicit multi-process '
                        'start (implies --distributed)')
    p.add_argument('--process-id', type=int, default=None,
                   help='this process\'s rank [with --coordinator]')
    p.add_argument('--n-processes', type=int, default=None,
                   help='total process count [with --coordinator]')
    return p


def parse_train_args(parser, argv=None):
    """Parse argv (the train CLIs' entry)."""
    return parser.parse_args(argv)


def sample_parser(**extra_flags):
    """The sample CLIs' parser (mvae_tpu/utils/cli.py:68-78) with --device;
    extra_flags: name -> add_argument keywords (the conditioning flags)."""
    p = argparse.ArgumentParser()
    p.add_argument('model_path', type=str, help='path to trained model file')
    p.add_argument('--n-samples', type=int, default=64)
    device_flag(p)
    p.add_argument('--data-dir', type=str, default='./data')
    p.add_argument('--out-dir', type=str, default='.')
    p.add_argument('--seed', type=int, default=0)
    for name, kw in extra_flags.items():
        p.add_argument(f'--{name.replace("_", "-")}', **kw)
    return p
