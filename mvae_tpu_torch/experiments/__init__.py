"""Command-line entry points of the port, one package per experiment."""
