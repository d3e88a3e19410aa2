"""Per-ray stackless BVH walk as a Pallas kernel for the GPU (Triton route).

The XLA walk in ``accel/bvh.py`` is a ``lax.while_loop`` over the whole
lane batch: every iteration is a separate launch of the loop body, its
predicate goes back to the host, and it runs until the slowest of all
lanes is done. This kernel runs the same walk with one program per block
of ``BLOCK`` rays. Each lane walks the escape-link array on its own with
its cursor, best t and best primitive in registers, and the block's loop
ends when its own last lane walks off the end -- all in one launch.

The BVH stays in device memory (``memory_space=pl.ANY``) and every lane
reads its own node and triangles with masked gathers from the packed
tables that ``bvh.build_bvh`` makes once per scene: 8-word node rows (one
32-byte sector per node step) and 9-word triangle rows.

The arithmetic is ``bvh.py``'s: the same slab test and the same
``LEAF_SIZE``-unrolled Möller-Trumbore with pre-computed edges, written
per component, so the face choice matches the XLA walk except on exact
ties. The kernel sees gradient-stopped rays and returns only the chosen
face; ``(t, u, v)`` are recomputed in closed form against that face
outside the kernel, so reverse mode never traces it.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from .bvh import COUNT_SHIFT, LEAF_SIZE, NODE_W, TRI_W, BVHArrays, hit_from_face
from .intersect import Hit, Rays

# One warp per 32-ray program: the fastest of the swept 32/64/128-ray
# blocks at 1-4 warps on camera and bounce rays (PERF.md).
BLOCK = 32
NUM_WARPS = 1
_OFFSET_MASK = (1 << COUNT_SHIFT) - 1
_BIG = 3.4e38  # bvh._BIG as a Python float: kernels capture no arrays


def _mt_components(o, d, p0, e1, e2):
    """``bvh._mt_pre`` on component tuples (Triton blocks are 1-D)."""
    ox, oy, oz = o
    dx, dy, dz = d
    px, py, pz = p0
    e1x, e1y, e1z = e1
    e2x, e2y, e2z = e2
    # pvec = d x e2
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    ok = jnp.abs(det) > 1e-8
    inv_det = 1.0 / jnp.where(ok, det, 1.0)
    tx, ty, tz = ox - px, oy - py, oz - pz
    u = (tx * pvx + ty * pvy + tz * pvz) * inv_det
    # qvec = tvec x e1
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    ok = ok & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
    return t, ok


def _walk_kernel(
    ox_ref, oy_ref, oz_ref, dx_ref, dy_ref, dz_ref, mint_ref, maxt_ref,
    nodes_ref, tris_ref, out_ref, *, n_nodes, n_prims,
):
    o = (ox_ref[...], oy_ref[...], oz_ref[...])
    d = (dx_ref[...], dy_ref[...], dz_ref[...])
    mint = mint_ref[...]
    maxt = maxt_ref[...]
    inv_d = tuple(1.0 / jnp.where(jnp.abs(c) < 1e-9, 1e-9, c) for c in d)

    def cond(state):
        cursor = state[0]
        return jnp.max((cursor < n_nodes).astype(jnp.int32)) > 0

    def body(state):
        cursor, best_t, best_p = state
        active = cursor < n_nodes
        base = jnp.minimum(cursor, n_nodes - 1) * NODE_W

        def node(k):
            return plt.load(nodes_ref.at[base + k], mask=active, other=0.0)

        # slab test (bvh._slab_test) against min(maxt, best_t)
        tmax = jnp.minimum(maxt, best_t)
        tnear = None
        tfar = None
        for a in range(3):
            t0 = (node(a) - o[a]) * inv_d[a]
            t1 = (node(3 + a) - o[a]) * inv_d[a]
            lo, hi = jnp.minimum(t0, t1), jnp.maximum(t0, t1)
            tnear = lo if tnear is None else jnp.maximum(tnear, lo)
            tfar = hi if tfar is None else jnp.minimum(tfar, hi)
        hit_box = (
            active & (tnear <= tfar) & (tfar >= mint) & (tnear <= tmax)
        )
        skip = jax.lax.bitcast_convert_type(node(6), jnp.int32)
        meta = jax.lax.bitcast_convert_type(node(7), jnp.int32)
        poff = meta & _OFFSET_MASK
        pcnt = jax.lax.shift_right_logical(meta, COUNT_SHIFT)
        is_leaf = pcnt > 0
        do_leaf = hit_box & is_leaf

        for k in range(LEAF_SIZE):
            live = do_leaf & (k < pcnt)
            pidx = jnp.minimum(poff + k, n_prims - 1)
            tb = pidx * TRI_W

            def tri(j):
                return plt.load(tris_ref.at[tb + j], mask=live, other=0.0)

            row = [tri(j) for j in range(TRI_W)]
            t, ok = _mt_components(o, d, row[0:3], row[3:6], row[6:9])
            ok = (
                ok & live & (t >= mint) & (t <= jnp.minimum(maxt, best_t))
            )
            best_p = jnp.where(ok, pidx, best_p)
            best_t = jnp.where(ok, t, best_t)

        descend = hit_box & ~is_leaf
        nxt = jnp.where(descend, cursor + 1, skip)
        cursor = jnp.where(active, nxt, cursor)
        return cursor, best_t, best_p

    n = mint.shape[0]
    init = (
        jnp.zeros((n,), jnp.int32),
        jnp.full((n,), _BIG, jnp.float32),
        jnp.full((n,), -1, jnp.int32),
    )
    _, _, best_p = jax.lax.while_loop(cond, body, init)
    out_ref[...] = best_p


@functools.partial(jax.jit, static_argnames=("interpret",))
def walk_prims(bvh: BVHArrays, o, d, mint, maxt, *, interpret=False):
    """Nearest-hit primitive index per ray (-1 = miss). Ray rows are
    padded to a multiple of ``BLOCK`` with dead lanes (maxt < 0)."""
    n = o.shape[0]
    pad = (-n) % BLOCK
    cols = [o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2], mint, maxt]
    fill = [0.0, 0.0, 0.0, 1.0, 1.0, 1.0, 0.0, -1.0]
    cols = [
        jnp.pad(c.astype(jnp.float32), (0, pad), constant_values=f)
        for c, f in zip(cols, fill)
    ]
    npad = n + pad
    lane = pl.BlockSpec((BLOCK,), lambda i: (i,))
    table = pl.BlockSpec(memory_space=pl.ANY)
    kernel = functools.partial(
        _walk_kernel,
        n_nodes=bvh.bounds_min.shape[0],
        n_prims=bvh.prim_faces.shape[0],
    )
    prims = pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((npad,), jnp.int32),
        grid=(npad // BLOCK,),
        in_specs=[lane] * 8 + [table, table],
        out_specs=lane,
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=NUM_WARPS, num_stages=1),
        interpret=interpret,
        name="bvh_walk",
    )(*cols, bvh.packed_nodes, bvh.packed_tris)
    return prims[:n]


def intersect_bvh_kernel(scene, rays: Rays, interpret=False) -> Hit:
    """Same ``Hit`` record as ``bvh.intersect_bvh``. Tests pass
    ``interpret=True``; the render path never does."""
    bvh: BVHArrays = scene.bvh
    rays_ng = jax.tree_util.tree_map(jax.lax.stop_gradient, rays)
    n = rays.o.shape[0]
    prim = walk_prims(
        bvh, rays_ng.o, rays_ng.d,
        jnp.broadcast_to(rays_ng.mint, (n,)),
        jnp.broadcast_to(rays_ng.maxt, (n,)),
        interpret=interpret,
    )
    face = bvh.prim_faces[jnp.maximum(prim, 0)]
    return hit_from_face(scene, rays, face, prim >= 0)
