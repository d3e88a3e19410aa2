"""Post-intersection shading preparation (the "hit-shade prep" stage).

Vectorized, differentiable port of the reference's post-Embree computation
(accel.cpp:113-236): Hanika shadow-terminator-corrected hit point, geometric
frame, UV interpolation, dpdu/dpdv tangent frame with degenerate-UV and
missing-normal fallbacks.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core import math as km
from ..core.math import Frame
from ..accel.intersect import Hit, Rays


class Interaction(NamedTuple):
    p: jnp.ndarray  # (N, 3) Hanika-corrected hit point
    t: jnp.ndarray  # (N,)
    uv: jnp.ndarray  # (N, 2)
    sh_frame: Frame  # shading frame (s, t, n) each (N, 3)
    geo_frame: Frame
    dpdu: jnp.ndarray  # (N, 3)
    dpdv: jnp.ndarray  # (N, 3)
    mesh: jnp.ndarray  # (N,) int32
    material: jnp.ndarray  # (N,) int32
    light: jnp.ndarray  # (N,) int32, -1 = not emissive
    valid: jnp.ndarray  # (N,) bool


class ROWS:
    """Trace-row layout: one (count, N) f32 matrix holds a trace's hit and
    the hit face's shading attributes, so the wavefront permutes one array
    per bounce. Ids are exact in f32 below 2^24 faces."""

    t = 0  # hit distance, ``big`` on a miss
    u = 1
    v = 2
    face = 3  # face id, -1 on a miss
    shade = slice(4, 28)  # face_shade row [p0 p1 p2 n0 n1 n2 uv0 uv1 uv2]
    light = 28  # light id, -1 = not emissive
    lpv = 29  # that light's primary visibility (0/1)
    mat = 30  # material id
    has_n = 31  # mesh has vertex normals (0/1)
    has_uv = 32  # mesh has uvs (0/1)
    count = 33
    big = 3.0e38


def prepare_from_rows(rays: Rays, rows) -> "tuple[Hit, Interaction]":
    """Shade prep from the trace rows (``ROWS`` layout): the face's
    vertices, normals, uvs and ids are already in the rows, so this is the
    accel.cpp:113-236 pipeline of ``prepare`` with no gathers.

    (t, u, v) are recomputed here in closed form against the chosen face so
    they stay differentiable w.r.t. the rays (the trace itself runs on
    gradient-stopped inputs); the geometry rows are constants, as with
    the gathered path (geometry gradients are not routed either way).
    """
    rows = jax.lax.stop_gradient(rows)
    face_f = rows[ROWS.face]
    valid = face_f >= 0.0
    face = jnp.where(valid, face_f, 0.0).astype(jnp.int32)
    shade = rows[ROWS.shade]
    p0 = shade[0:3].T
    p1 = shade[3:6].T
    p2 = shade[6:9].T
    n0 = shade[9:12].T
    n1 = shade[12:15].T
    n2 = shade[15:18].T
    uv0 = shade[18:20].T
    uv1 = shade[20:22].T
    uv2 = shade[22:24].T
    light = jnp.where(valid, rows[ROWS.light], -1.0).astype(jnp.int32)
    material = rows[ROWS.mat].astype(jnp.int32)
    has_n = rows[ROWS.has_n] > 0.0
    has_uv = rows[ROWS.has_uv] > 0.0

    from ..accel.intersect import moller_trumbore

    t, u, v, _ = moller_trumbore(rays.o, rays.d, p0, p1, p2)
    t = jnp.where(valid, t, rows[ROWS.t])
    hit = Hit(valid=valid, t=t, face=face, u=u, v=v)
    its = _prepare_core(
        hit, p0, p1, p2, n0, n1, n2, uv0, uv1, uv2,
        jnp.zeros_like(face), material, light, has_n, has_uv,
    )
    return hit, its


def prepare(scene, rays: Rays, hit: Hit) -> Interaction:
    f = jnp.clip(hit.face, 0, scene.F.shape[0] - 1)
    row = scene.face_shade[f]  # (N, 24): one contiguous gather
    p0 = row[:, 0:3]
    p1 = row[:, 3:6]
    p2 = row[:, 6:9]
    n0 = row[:, 9:12]
    n1 = row[:, 12:15]
    n2 = row[:, 15:18]
    uv0 = row[:, 18:20]
    uv1 = row[:, 20:22]
    uv2 = row[:, 22:24]

    mesh = scene.face_mesh[f]
    has_n = scene.mesh_has_normals[mesh]
    has_uv = scene.mesh_has_uvs[mesh]
    material = scene.mesh_material[mesh]
    light = scene.mesh_light[mesh]
    return _prepare_core(
        hit, p0, p1, p2, n0, n1, n2, uv0, uv1, uv2,
        mesh, material, light, has_n, has_uv,
    )


def _prepare_core(
    hit, p0, p1, p2, n0, n1, n2, uv0, uv1, uv2,
    mesh, material, light, has_n, has_uv,
) -> Interaction:
    b0 = (1.0 - hit.u - hit.v)[:, None]
    b1 = hit.u[:, None]
    b2 = hit.v[:, None]

    # Hanika 2021 terminator offset (accel.cpp:141-153): project the
    # barycentric point onto each vertex-normal tangent plane and re-average.
    orig_p = b0 * p0 + b1 * p1 + b2 * p2
    tmpu = orig_p - p0
    tmpv = orig_p - p1
    tmpw = orig_p - p2
    dotu = jnp.minimum(0.0, km.dot(tmpu, n0))[:, None]
    dotv = jnp.minimum(0.0, km.dot(tmpv, n1))[:, None]
    dotw = jnp.minimum(0.0, km.dot(tmpw, n2))[:, None]
    tmpu = tmpu - dotu * n0
    tmpv = tmpv - dotv * n1
    tmpw = tmpw - dotw * n2
    p_hanika = orig_p + b0 * tmpu + b1 * tmpv + b2 * tmpw
    # Without vertex normals the offset is meaningless -- use the plain point.
    p = jnp.where(has_n[:, None], p_hanika, orig_p)

    # Geometric frame (accel.cpp:156-158)
    dp0 = p1 - p0
    dp1 = p2 - p0
    gn = km.normalize(km.cross(dp0, dp1))
    geo_frame = km.frame_from_normal(gn)

    # UV interpolation (accel.cpp:160-164); prim uv fallback otherwise
    uv_interp = b0 * uv0 + b1 * uv1 + b2 * uv2
    uv = jnp.where(has_uv[:, None], uv_interp, jnp.stack([hit.u, hit.v], -1))

    # Shading frame (accel.cpp:166-235)
    sh_normal = b0 * n0 + b1 * n1 + b2 * n2
    sh_n = km.normalize(sh_normal)

    duv0 = uv1 - uv0
    duv1 = uv2 - uv0
    determinant = duv0[:, 0] * duv1[:, 1] - duv0[:, 1] * duv1[:, 0]
    cross_len = km.norm(km.cross(dp0, dp1))
    uv_ok = has_n & has_uv & (cross_len > 0.0) & (determinant > 0.0)

    inv_det = 1.0 / jnp.where(determinant != 0.0, determinant, 1.0)
    dpdu_uv = (duv1[:, 1:2] * dp0 - duv0[:, 1:2] * dp1) * inv_det[:, None]
    dpdv_uv = (-duv1[:, 0:1] * dp0 + duv0[:, 0:1] * dp1) * inv_det[:, None]

    # Gram-Schmidt tangent frame from dpdu (accel.cpp:197-200)
    s_uv = km.normalize(
        dpdu_uv - sh_normal * km.dot(sh_normal, dpdu_uv, keepdims=True)
    )
    t_uv = km.normalize(km.cross(sh_n, s_uv))

    # Fallback: arbitrary frame around the (shading or geometric) normal
    n_fallback = jnp.where(has_n[:, None], sh_n, gn)
    fallback = km.frame_from_normal(n_fallback)

    sh_frame = Frame(
        s=jnp.where(uv_ok[:, None], s_uv, fallback.s),
        t=jnp.where(uv_ok[:, None], t_uv, fallback.t),
        n=jnp.where(uv_ok[:, None], sh_n, n_fallback),
    )
    dpdu = jnp.where(uv_ok[:, None], dpdu_uv, fallback.s)
    dpdv = jnp.where(uv_ok[:, None], dpdv_uv, fallback.t)

    return Interaction(
        p=p,
        t=hit.t,
        uv=uv,
        sh_frame=sh_frame,
        geo_frame=geo_frame,
        dpdu=dpdu,
        dpdv=dpdv,
        mesh=mesh,
        material=material,
        light=jnp.where(hit.valid, light, -1),
        valid=hit.valid,
    )
