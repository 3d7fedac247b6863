"""ELBO-term subset sampling for CelebA-19, the "approx-m" terms (the port's
copy of mvae_tpu/core/subsets.py, numpy only).

The reference (celeba19/train.py:87-142, 286-302) enumerates every subset
of size 2..n-1 of the n = 19 experts and draws m of them a step,
stratified by size: m sizes s ~ U{2..n-1} with replacement, then within
each size class that many distinct uniform s-subsets. The direct sampler
here draws the same distribution without the 2^19-row pool (rejection of
repeats within a class); the rows come grouped by size, ascending. The
same numpy Generator state gives the same masks as the JAX package's.
"""

import math

import numpy as np


def sample_subset_masks(rng: np.random.Generator, m: int, n: int = 19
                        ) -> np.ndarray:
    """(m, n) 0/1 masks; sizes uniform over 2..n-1 with replacement,
    subsets distinct within each size class."""
    sizes = rng.integers(2, n, size=m)         # 2..n-1 inclusive
    masks = np.zeros((m, n), np.float32)
    row = 0
    for s in sorted(set(int(v) for v in sizes)):
        count = int(np.sum(sizes == s))
        if count > math.comb(n, s):
            raise ValueError(
                f"cannot draw {count} distinct subsets of size {s} from "
                f"{n} modalities")
        seen = []
        while len(seen) < count:
            idx = tuple(sorted(rng.choice(n, size=s, replace=False)))
            if idx not in seen:
                seen.append(idx)
        for combo in seen:
            masks[row, list(combo)] = 1.0
            row += 1
    return masks


def celeba19_static_terms(n_attrs: int, lambda_image: float,
                          lambda_attrs: float):
    """The 20 fixed terms (celeba19/train.py:263-283): complete and
    image-only with the given lambdas, then the 18 single-attribute terms
    with lambdas 1 (the reference calls elbo_loss without them there).
    Returns (masks (20, 1+n), lambdas (20, 1+n))."""
    n = 1 + n_attrs
    masks = np.zeros((2 + n_attrs, n), np.float32)
    lambdas = np.ones_like(masks)
    masks[0, :] = 1.0                  # complete
    lambdas[0, 0] = lambda_image
    lambdas[0, 1:] = lambda_attrs
    masks[1, 0] = 1.0                  # image only
    lambdas[1, 0] = lambda_image
    lambdas[1, 1:] = lambda_attrs
    for i in range(n_attrs):           # single attribute, lambdas 1
        masks[2 + i, 1 + i] = 1.0
    return masks, lambdas


def celeba19_recon_support(m: int, n_attrs: int = 18) -> np.ndarray:
    """(20+m, 19) 0/1 upper bound of the terms' recon weights, known before
    the step: the fixed terms' pattern, and all ones for the m sampled
    terms. Its image column names the terms --fast-term-decode decodes
    the image of."""
    n = 1 + n_attrs
    sup = np.zeros((2 + n_attrs + m, n), np.float32)
    sup[0] = 1.0
    sup[1, 0] = 1.0
    for i in range(n_attrs):
        sup[2 + i, 1 + i] = 1.0
    sup[2 + n_attrs:] = 1.0
    return sup


def celeba19_step_terms(rng, m: int, n_attrs: int, lambda_image: float,
                        lambda_attrs: float):
    """One step's (20+m, 19) masks and lambdas: the fixed terms, then m
    sampled subset terms with lambdas 1 (celeba19/train.py:294-304)."""
    static_m, static_l = celeba19_static_terms(n_attrs, lambda_image,
                                               lambda_attrs)
    if m <= 0:
        return static_m, static_l
    samp = sample_subset_masks(rng, m, 1 + n_attrs)
    return (np.concatenate([static_m, samp]),
            np.concatenate([static_l, np.ones_like(samp)]))
