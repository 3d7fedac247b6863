"""The CLIs' argument parsers (counterpart of mvae_tpu/utils/cli.py:7-78):
the reference's flag surface with the JAX package's defaults, without
--cuda (the port runs on the card unless --device says otherwise) and
--exact-decode (it decodes real images with PIL, the exact path, always),
plus --device.

--no-device-data streams the batches from the host (train/driver.py).
The flags of the JAX package's distributed paths stay on the parser so
that a command line written for it is understood, and `parse_train_args`
refuses them: multi-process runs and the mesh are not ported yet.
"""

import argparse

NOT_PORTED = ("distributed", "coordinator", "process_id", "n_processes")


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
    p.add_argument('--distributed', action='store_true', default=False,
                   help='not ported yet (multi-process): refused')
    p.add_argument('--coordinator', type=str, default=None,
                   help='not ported yet (multi-process): refused')
    p.add_argument('--process-id', type=int, default=None,
                   help='not ported yet (multi-process): refused')
    p.add_argument('--n-processes', type=int, default=None,
                   help='not ported yet (multi-process): refused')
    return p


def parse_train_args(parser, argv=None):
    """Parse argv; exit through parser.error on a flag of a path that is
    not ported yet."""
    args = parser.parse_args(argv)
    for name in NOT_PORTED:
        if getattr(args, name) not in (None, False):
            parser.error(f"--{name.replace('_', '-')} is not ported yet: "
                         "the port trains on one device")
    return args


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
