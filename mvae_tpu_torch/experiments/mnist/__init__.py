"""MNIST CLIs of the port: train, sample, loglike."""
