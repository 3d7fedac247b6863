"""MultiMNIST CLIs of the port: train, sample, loglike, datasets."""
