"""Datasets of the port: host numpy arrays and their epoch batching (the
port's copies of mvae_tpu/data/pipeline.py and data/celeba.py)."""
