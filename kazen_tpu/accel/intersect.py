"""Ray-triangle intersection stages.

``intersect_brute`` is the reference-semantics oracle: Möller-Trumbore
(mesh.cpp:55-92) over every triangle, fully vectorized (N rays x F faces).
It defines the u/v/t conventions the shading stages expect
(hit = (1-u-v)p0 + u p1 + v p2) and is used for small scenes and as the
ground truth the BVH traversal is tested against.

The production path is the flattened BVH with stackless traversal
(``accel.bvh``, and ``accel.bvh_kernel`` on the GPU). All produce the same
``Hit`` record.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core import math as km


class Rays(NamedTuple):
    o: jnp.ndarray  # (N, 3)
    d: jnp.ndarray  # (N, 3)
    mint: jnp.ndarray  # (N,)
    maxt: jnp.ndarray  # (N,)


class Hit(NamedTuple):
    valid: jnp.ndarray  # (N,) bool
    t: jnp.ndarray  # (N,)
    face: jnp.ndarray  # (N,) int32 global face id (undefined if !valid)
    u: jnp.ndarray  # (N,) barycentric u
    v: jnp.ndarray  # (N,) barycentric v


_DET_EPS = 1e-8
_BIG = jnp.float32(3.4e38)


def moller_trumbore(o, d, p0, p1, p2):
    """Batched Möller-Trumbore on matching shapes (..., 3).

    Returns (t, u, v, ok) where ok ignores the ray's [mint, maxt] interval.
    """
    e1 = p1 - p0
    e2 = p2 - p0
    pvec = km.cross(d, e2)
    det = km.dot(e1, pvec)
    ok = jnp.abs(det) > _DET_EPS
    inv_det = 1.0 / jnp.where(ok, det, 1.0)
    tvec = o - p0
    u = km.dot(tvec, pvec) * inv_det
    qvec = km.cross(tvec, e1)
    v = km.dot(d, qvec) * inv_det
    t = km.dot(e2, qvec) * inv_det
    ok = ok & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
    return t, u, v, ok


def intersect_brute(scene, rays: Rays) -> Hit:
    """All-faces nearest-hit intersection; O(N*F), oracle/testing path.

    Implemented as a scan over faces keeping (N,)-shaped running best-hit
    state, so memory stays O(N) instead of the (N, F) broadcast form's.
    """
    p0 = scene.V[scene.F[:, 0]]  # (F, 3)
    e1 = scene.V[scene.F[:, 1]] - p0
    e2 = scene.V[scene.F[:, 2]] - p0
    n = rays.o.shape[0]

    def body(carry, tri):
        best_t, face, bu, bv, found, fidx = carry
        tp0, te1, te2 = tri
        pvec = km.cross(rays.d, te2[None, :])
        det = km.dot(e1_b(te1), pvec)
        ok = jnp.abs(det) > _DET_EPS
        inv_det = 1.0 / jnp.where(ok, det, 1.0)
        tvec = rays.o - tp0[None, :]
        u = km.dot(tvec, pvec) * inv_det
        qvec = km.cross(tvec, e1_b(te1))
        v = km.dot(rays.d, qvec) * inv_det
        t = km.dot(e2_b(te2), qvec) * inv_det
        ok = (
            ok
            & (u >= 0.0)
            & (u <= 1.0)
            & (v >= 0.0)
            & (u + v <= 1.0)
            & (t >= rays.mint)
            & (t <= rays.maxt)
            & (t < best_t)
        )
        best_t = jnp.where(ok, t, best_t)
        face = jnp.where(ok, fidx, face)
        bu = jnp.where(ok, u, bu)
        bv = jnp.where(ok, v, bv)
        found = found | ok
        return (best_t, face, bu, bv, found, fidx + 1), None

    def e1_b(x):
        return x[None, :]

    def e2_b(x):
        return x[None, :]

    init = (
        jnp.full(n, _BIG),
        jnp.zeros(n, jnp.int32),
        jnp.zeros(n, jnp.float32),
        jnp.zeros(n, jnp.float32),
        jnp.zeros(n, bool),
        jnp.int32(0),
    )
    (t, face, u, v, found, _), _ = jax.lax.scan(body, init, (p0, e1, e2))
    return Hit(valid=found, t=t, face=face, u=u, v=v)
