"""Utilities of the port: the weight carry-across, the CLI parser and the
profiler hook."""
