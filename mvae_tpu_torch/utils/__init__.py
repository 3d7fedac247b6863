"""Utilities of the port: the weight carry-across."""
