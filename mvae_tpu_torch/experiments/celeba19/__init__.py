"""CelebA-19 CLIs of the port: train, sample, loglike."""
