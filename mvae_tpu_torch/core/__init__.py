"""Core math of the port: PoE fusion, losses, sampling, the ELBO engine."""
