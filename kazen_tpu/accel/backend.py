"""The one place that chooses the trace backend from the platform.

``"gpu"`` runs the per-ray Pallas BVH walk (``accel/bvh_kernel.py``),
``"cpu"`` the XLA walk (``accel/bvh.py``); any other platform is refused.
Scenes without a BVH use the brute-force oracle on every platform.
"""
from __future__ import annotations

import jax

_WALKS = {"gpu": "kernel", "cpu": "xla"}


def trace_backend(platform=None) -> str:
    """``"kernel"`` or ``"xla"`` for ``platform`` (default: JAX's)."""
    platform = jax.default_backend() if platform is None else platform
    try:
        return _WALKS[platform]
    except KeyError:
        raise RuntimeError(
            f"no trace backend for JAX platform {platform!r}: kazen_tpu "
            f"runs on {' or '.join(map(repr, _WALKS))}"
        ) from None


def bvh_walk(platform=None):
    """The nearest-hit BVH walk ``fn(scene, rays) -> Hit`` for ``platform``."""
    if trace_backend(platform) == "kernel":
        from .bvh_kernel import intersect_bvh_kernel

        return intersect_bvh_kernel
    from .bvh import intersect_bvh

    return intersect_bvh
