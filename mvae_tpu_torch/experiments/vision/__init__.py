"""Vision CLIs of the port: train, sample, loglike, and setup (the
offline grayscale, edge and mask variants)."""
