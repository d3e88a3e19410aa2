"""Discrete PDF over array entries (dpdf.h:14-169) as prefix-sum + searchsorted.

The reference's DiscretePDF is an append/normalize/sample CDF table with
binary search (dpdf.h:99-104). Here the CDF is a device array built once at
scene-compile time; sampling is a vectorized ``searchsorted`` gather, which
is the vectorized form (no per-sample mutation, O(log n) per lane).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import jax.numpy as jnp
import numpy as np


class DiscretePDF(NamedTuple):
    cdf: jnp.ndarray  # (n + 1,) inclusive prefix sums, cdf[0] = 0, cdf[-1] = 1
    normalization: jnp.ndarray  # scalar: 1 / sum of unnormalized weights


def build(weights) -> DiscretePDF:
    """Host- or trace-time build: normalize() (dpdf.h:70-86)."""
    w = jnp.asarray(weights, jnp.float32)
    cdf = jnp.concatenate([jnp.zeros((1,), w.dtype), jnp.cumsum(w)])
    total = cdf[-1]
    return DiscretePDF(cdf=cdf / total, normalization=1.0 / total)


def build_np(weights) -> Tuple[np.ndarray, float]:
    w = np.asarray(weights, np.float32)
    cdf = np.concatenate([[0.0], np.cumsum(w, dtype=np.float64)]).astype(np.float32)
    total = float(cdf[-1])
    return cdf / total, 1.0 / total


def sample(d: DiscretePDF, u):
    """sample(u) -> index (dpdf.h:99-111): smallest i with cdf[i+1] > u."""
    idx = jnp.searchsorted(d.cdf, u, side="right") - 1
    return jnp.clip(idx, 0, d.cdf.shape[0] - 2)


def sample_reuse(d: DiscretePDF, u):
    """sampleReuse (dpdf.h:131-141): also rescale u within the chosen bin."""
    idx = sample(d, u)
    lo = d.cdf[idx]
    hi = d.cdf[idx + 1]
    return idx, (u - lo) / jnp.maximum(hi - lo, 1e-9)


def pdf_of(d: DiscretePDF, idx):
    return d.cdf[idx + 1] - d.cdf[idx]
