"""BVH: host-side binned-SAH build + flattened, stackless traversal.

This replaces the reference's Embree3 dependency (accel.cpp:25-110, SURVEY
§2.2):

* Build (numpy, at scene-compile time): recursive binned SAH (16 bins over
  the centroid extent's widest axis, leaf <= 4 prims), flattened in DFS
  order with *escape links*: ``skip[i]`` is the node to visit when node i's
  box is missed (or after a leaf) -- the classic threaded layout that makes
  traversal a single while-loop with no per-lane stack.

* Traversal (pure jnp, under jit): every ray carries a node cursor; each
  iteration does one AABB slab test (bbox.h:316-343 semantics) plus up to
  LEAF_SIZE masked Möller-Trumbore tests, then steps the cursor to
  ``cursor+1`` (enter) or ``skip`` (miss/after-leaf). The loop runs until
  every lane has walked off the end. Rays prune with their current best t.

On the GPU the same walk runs per ray as a Pallas kernel
(accel/bvh_kernel.py); accel/backend.py chooses between the two.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core import math as km
from .intersect import Hit, Rays

LEAF_SIZE = 4
_SAH_BINS = 16
_BIG = jnp.float32(3.4e38)


class BVHArrays(NamedTuple):
    bounds_min: jnp.ndarray  # (M, 3)
    bounds_max: jnp.ndarray  # (M, 3)
    skip: jnp.ndarray  # (M,) int32: next node on miss / after leaf
    prim_offset: jnp.ndarray  # (M,) int32 into prim_faces (leaves)
    prim_count: jnp.ndarray  # (M,) int32, 0 for internal nodes
    prim_faces: jnp.ndarray  # (F,) int32 global face ids, leaf-contiguous
    # pre-gathered leaf triangle vertices in prim order (SoA, avoids a
    # double indirection in the hot loop)
    tri_p0: jnp.ndarray  # (F, 3)
    tri_e1: jnp.ndarray  # (F, 3)
    tri_e2: jnp.ndarray  # (F, 3)
    # the same tables packed for the GPU walk (accel/bvh_kernel.py), made
    # once here: (M * NODE_W,) node rows [bmin xyz, bmax xyz, skip,
    # prim_offset | prim_count << COUNT_SHIFT], the two integer words
    # stored as their bit patterns, and (F * TRI_W,) triangle rows
    # [p0 xyz, e1 xyz, e2 xyz] in primitive order
    packed_nodes: jnp.ndarray
    packed_tris: jnp.ndarray


NODE_W = 8
TRI_W = 9
COUNT_SHIFT = 28  # prim_count <= LEAF_SIZE fits above a 28-bit offset


def _arrays(bmin, bmax, skip, poff, pcnt, pfaces, p0, p1, p2) -> BVHArrays:
    """Device BVHArrays from the numpy node table, leaf order and
    per-face vertices."""
    bmin = np.asarray(bmin, np.float32)
    bmax = np.asarray(bmax, np.float32)
    skip = np.asarray(skip, np.int32)
    poff = np.asarray(poff, np.int32)
    pcnt = np.asarray(pcnt, np.int32)
    pfaces = np.asarray(pfaces, np.int32)
    tp0 = p0[pfaces]
    te1 = p1[pfaces] - tp0
    te2 = p2[pfaces] - tp0
    ints = np.stack([skip, poff | (pcnt << COUNT_SHIFT)], -1).view(np.float32)
    return BVHArrays(
        bounds_min=jnp.asarray(bmin),
        bounds_max=jnp.asarray(bmax),
        skip=jnp.asarray(skip),
        prim_offset=jnp.asarray(poff),
        prim_count=jnp.asarray(pcnt),
        prim_faces=jnp.asarray(pfaces),
        tri_p0=jnp.asarray(tp0),
        tri_e1=jnp.asarray(te1),
        tri_e2=jnp.asarray(te2),
        packed_nodes=jnp.asarray(
            np.concatenate([bmin, bmax, ints], -1).reshape(-1)
        ),
        packed_tris=jnp.asarray(
            np.concatenate([tp0, te1, te2], -1).reshape(-1)
        ),
    )


def build_bvh(
    V: np.ndarray,
    F: np.ndarray,
    leaf_size: int = LEAF_SIZE,
    backend: str = "auto",
):
    """Binned-SAH build; returns BVHArrays (device) from numpy geometry.

    backend: 'auto' uses the native C++ builder (accel/native) when
    available, falling back to the numpy recursion; 'numpy'/'native' force.
    """
    V = np.asarray(V, np.float32)
    F = np.asarray(F, np.int32)
    nf = len(F)
    if nf == 0:
        raise ValueError("empty scene")

    from ..utils.metrics import LOG

    if backend in ("auto", "native"):
        from . import native

        res = native.build(V, F, leaf_size)
        if res is not None:
            LOG(f"BVH build: native builder, {nf} faces")
            return _arrays(*res, V[F[:, 0]], V[F[:, 1]], V[F[:, 2]])
        if backend == "native":
            raise RuntimeError(
                f"native BVH builder unavailable ({native.reason})"
            )
        LOG(
            f"BVH build: numpy builder, {nf} faces (native builder "
            f"unavailable: {native.reason})"
        )

    p0 = V[F[:, 0]]
    p1 = V[F[:, 1]]
    p2 = V[F[:, 2]]
    fmin = np.minimum(np.minimum(p0, p1), p2)
    fmax = np.maximum(np.maximum(p0, p1), p2)
    centroid = (fmin + fmax) * 0.5

    bounds_min, bounds_max, skip, prim_offset, prim_count = [], [], [], [], []
    prim_faces = []

    def emit(face_ids) -> None:
        node = len(bounds_min)
        bounds_min.append(fmin[face_ids].min(axis=0))
        bounds_max.append(fmax[face_ids].max(axis=0))
        skip.append(-1)  # patched after subtree is emitted
        if len(face_ids) <= leaf_size:
            prim_offset.append(len(prim_faces))
            prim_count.append(len(face_ids))
            prim_faces.extend(face_ids.tolist())
        else:
            prim_offset.append(0)
            prim_count.append(0)
            c = centroid[face_ids]
            ext = c.max(axis=0) - c.min(axis=0)
            axis = int(np.argmax(ext))
            left_ids = right_ids = None
            if ext[axis] > 1e-12:
                # binned SAH over the widest centroid axis
                lo = c[:, axis].min()
                scale = _SAH_BINS * (1.0 - 1e-6) / ext[axis]
                bins = np.minimum(
                    ((c[:, axis] - lo) * scale).astype(np.int32), _SAH_BINS - 1
                )
                best_cost = np.inf
                best_split = -1
                for split in range(1, _SAH_BINS):
                    lmask = bins < split
                    nl = int(lmask.sum())
                    nr = len(face_ids) - nl
                    if nl == 0 or nr == 0:
                        continue
                    lmin = fmin[face_ids[lmask]].min(axis=0)
                    lmax = fmax[face_ids[lmask]].max(axis=0)
                    rmin = fmin[face_ids[~lmask]].min(axis=0)
                    rmax = fmax[face_ids[~lmask]].max(axis=0)
                    area = lambda mn, mx: float(
                        np.maximum(mx - mn, 0).prod() * 0
                        + 2
                        * (
                            (mx[0] - mn[0]) * (mx[1] - mn[1])
                            + (mx[1] - mn[1]) * (mx[2] - mn[2])
                            + (mx[0] - mn[0]) * (mx[2] - mn[2])
                        )
                    )
                    cost = nl * area(lmin, lmax) + nr * area(rmin, rmax)
                    if cost < best_cost:
                        best_cost = cost
                        best_split = split
                if best_split > 0:
                    lmask = bins < best_split
                    left_ids = face_ids[lmask]
                    right_ids = face_ids[~lmask]
            if left_ids is None:
                # degenerate centroids: median split
                order = np.argsort(c[:, axis], kind="stable")
                half = len(order) // 2
                left_ids = face_ids[order[:half]]
                right_ids = face_ids[order[half:]]
            emit(left_ids)
            emit(right_ids)
        skip[node] = len(bounds_min)

    emit(np.arange(nf, dtype=np.int32))

    return _arrays(
        bounds_min, bounds_max, skip, prim_offset, prim_count, prim_faces,
        p0, p1, p2,
    )


def _slab_test(o, inv_d, mint, maxt, bmin, bmax):
    """Ray-AABB slab test (bbox.h:316-343 semantics, branch-free)."""
    t0 = (bmin - o) * inv_d
    t1 = (bmax - o) * inv_d
    tnear = jnp.max(jnp.minimum(t0, t1), axis=-1)
    tfar = jnp.min(jnp.maximum(t0, t1), axis=-1)
    return (tnear <= tfar) & (tfar >= mint) & (tnear <= maxt)


def intersect_bvh(scene, rays: Rays) -> Hit:
    """Vectorized stackless traversal; same Hit record as intersect_brute.

    The while_loop walk is not reverse-differentiable, and the face choice
    is discrete anyway: the walk runs on gradient-stopped rays, then
    (t, u, v) are recomputed in closed form against the chosen face so
    gradients flow exactly as in the brute-force oracle.
    """
    bvh: BVHArrays = scene.bvh
    n = rays.o.shape[0]
    n_nodes = bvh.bounds_min.shape[0]
    rays_ng = jax.tree_util.tree_map(jax.lax.stop_gradient, rays)
    inv_d = 1.0 / jnp.where(jnp.abs(rays_ng.d) < 1e-9, 1e-9, rays_ng.d)

    def cond(state):
        cursor = state[0]
        return jnp.any(cursor < n_nodes)

    def body(state):
        cursor, best_t, best_face, best_u, best_v, found = state
        cur = jnp.minimum(cursor, n_nodes - 1)
        bmin = bvh.bounds_min[cur]
        bmax = bvh.bounds_max[cur]
        active = cursor < n_nodes
        maxt = jnp.minimum(rays_ng.maxt, best_t)
        hit_box = active & _slab_test(
            rays_ng.o, inv_d, rays_ng.mint, maxt, bmin, bmax
        )

        pcnt = bvh.prim_count[cur]
        poff = bvh.prim_offset[cur]
        is_leaf = pcnt > 0
        do_leaf = hit_box & is_leaf
        for k in range(LEAF_SIZE):
            pidx = jnp.minimum(poff + k, bvh.prim_faces.shape[0] - 1)
            tp0 = bvh.tri_p0[pidx]
            te1 = bvh.tri_e1[pidx]
            te2 = bvh.tri_e2[pidx]
            t, u, v, ok = _mt_pre(rays_ng.o, rays_ng.d, tp0, te1, te2)
            ok = (
                ok
                & do_leaf
                & (k < pcnt)
                & (t >= rays_ng.mint)
                & (t <= jnp.minimum(rays_ng.maxt, best_t))
            )
            best_face = jnp.where(ok, bvh.prim_faces[pidx], best_face)
            best_u = jnp.where(ok, u, best_u)
            best_v = jnp.where(ok, v, best_v)
            found = found | ok
            best_t = jnp.where(ok, t, best_t)

        descend = hit_box & ~is_leaf
        nxt = jnp.where(descend, cursor + 1, bvh.skip[cur])
        cursor = jnp.where(active, nxt, cursor)
        return cursor, best_t, best_face, best_u, best_v, found

    init = (
        jnp.zeros(n, jnp.int32),
        jnp.full(n, _BIG),
        jnp.zeros(n, jnp.int32),
        jnp.zeros(n, jnp.float32),
        jnp.zeros(n, jnp.float32),
        jnp.zeros(n, bool),
    )
    _, _, face, _, _, found = jax.lax.while_loop(cond, body, init)
    return hit_from_face(scene, rays, face, found)


def hit_from_face(scene, rays: Rays, face, found) -> Hit:
    """The Hit for a chosen face: (t, u, v) are recomputed in closed form
    against it, so gradients flow exactly as in the brute-force oracle."""
    idx = scene.F[jnp.clip(face, 0, scene.F.shape[0] - 1)]
    p0 = scene.V[idx[:, 0]]
    t, u, v, _ = _mt_pre(
        rays.o, rays.d, p0, scene.V[idx[:, 1]] - p0, scene.V[idx[:, 2]] - p0
    )
    return Hit(valid=found, t=t, face=face, u=u, v=v)


def _mt_pre(o, d, p0, e1, e2):
    """Möller-Trumbore with pre-computed edges (mesh.cpp:55-92 semantics)."""
    pvec = km.cross(d, e2)
    det = km.dot(e1, pvec)
    ok = jnp.abs(det) > 1e-8
    inv_det = 1.0 / jnp.where(ok, det, 1.0)
    tvec = o - p0
    u = km.dot(tvec, pvec) * inv_det
    qvec = km.cross(tvec, e1)
    v = km.dot(d, qvec) * inv_det
    t = km.dot(e2, qvec) * inv_det
    ok = ok & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
    return t, u, v, ok
