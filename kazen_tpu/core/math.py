"""Batched vector math: frames, optics, color transforms.

Pure jnp functions over arrays whose last axis is the vector axis, replacing
the reference's Eigen scalar types (vector.h, frame.h, common.cpp:396-538).
Everything is differentiable and written branch-free (jnp.where instead of
scalar control flow) so it fuses under jit.
"""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

EPSILON = 1e-4
INV_PI = 1.0 / jnp.pi
INV_TWOPI = 0.5 / jnp.pi
INV_FOURPI = 0.25 / jnp.pi


def select_rows(idx, table, max_unroll: int = 40):
    """Exact small-table row fetch as a statically unrolled where-chain.

    For small tables (materials, lights) a chain of
    ``where(idx == l, table[l], ...)`` fuses into the surrounding
    elementwise work instead of a separate gather, and is bit-exact.
    Whether it beats a plain gather on the GPU is not measured yet.
    Falls back to a plain gather above ``max_unroll`` rows."""
    L = table.shape[0]
    if L > max_unroll:
        return table[idx]
    extra = (1,) * (table.ndim - 1)
    out = jnp.broadcast_to(
        table[0], idx.shape + table.shape[1:]
    ).astype(table.dtype)
    for l in range(1, L):
        cond = (idx == l).reshape(idx.shape + extra)
        out = jnp.where(cond, table[l], out)
    return out


def dot(a, b, keepdims: bool = False):
    return jnp.sum(a * b, axis=-1, keepdims=keepdims)


def cross(a, b):
    return jnp.cross(a, b)


def norm(v, keepdims: bool = False):
    # clamp keeps d(sqrt)/dx finite at zero-length (masked-lane grad safety)
    return jnp.sqrt(jnp.maximum(dot(v, v, keepdims=keepdims), 1e-18))


def normalize(v):
    return v / jnp.maximum(norm(v, keepdims=True), 1e-9)


def sqr(x):
    return x * x


def vec3(x, y, z):
    return jnp.stack(jnp.broadcast_arrays(x, y, z), axis=-1)


def lerp(t, a, b):
    return (1.0 - t) * a + t * b


# ---------------------------------------------------------------------------
# Orthonormal frames (frame.h:14-127, coordinateSystem common.cpp:434-445)
# ---------------------------------------------------------------------------


class Frame(NamedTuple):
    """Shading/geometric frame: rows s, t, n each (..., 3)."""

    s: jnp.ndarray
    t: jnp.ndarray
    n: jnp.ndarray

    def to_local(self, v):
        return vec3(dot(v, self.s), dot(v, self.t), dot(v, self.n))

    def to_world(self, v):
        return (
            self.s * v[..., 0:1] + self.t * v[..., 1:2] + self.n * v[..., 2:3]
        )


def coordinate_system(a):
    """Branch-free port of coordinateSystem (common.cpp:434-445):
    returns (b, c) with c chosen per the |a.x|>|a.y| rule and b = c x a."""
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    use_x = jnp.abs(ax) > jnp.abs(ay)
    inv_len_x = 1.0 / jnp.sqrt(ax * ax + az * az + 1e-30)
    inv_len_y = 1.0 / jnp.sqrt(ay * ay + az * az + 1e-30)
    c_x = vec3(az * inv_len_x, jnp.zeros_like(ax), -ax * inv_len_x)
    c_y = vec3(jnp.zeros_like(ax), az * inv_len_y, -ay * inv_len_y)
    c = jnp.where(use_x[..., None], c_x, c_y)
    b = cross(c, a)
    return b, c


def frame_from_normal(n) -> Frame:
    s, t = coordinate_system(n)
    return Frame(s=s, t=t, n=n)


def cos_theta(v):
    return v[..., 2]


def sin_theta2(v):
    return 1.0 - v[..., 2] * v[..., 2]


def sin_theta(v):
    return jnp.sqrt(jnp.maximum(sin_theta2(v), 0.0))


def tan_theta(v):
    return jnp.sqrt(jnp.maximum(1.0 - v[..., 2] * v[..., 2], 0.0)) / v[..., 2]


# ---------------------------------------------------------------------------
# Optics (common.cpp:447-538)
# ---------------------------------------------------------------------------


def reflect(wi, n):
    """2(n.wi)n - wi (common.cpp:535-537); both wi and result point away."""
    return 2.0 * dot(wi, n, keepdims=True) * n - wi


def refract(wi, n, eta):
    """Snell refraction (common.cpp:522-532); returns 0 on TIR.

    The TIR branch substitutes the sqrt argument BEFORE the sqrt:
    sqrt(maximum(x, 0)) at x <= 0 produces a 0/(2*sqrt(0)) = NaN in
    reverse mode even with a zero cotangent, which poisons autodiff for
    the whole batch whenever any lane hits TIR."""
    cos_i = dot(wi, n)
    eta_eff = jnp.where(cos_i < 0.0, 1.0 / eta, eta)
    cos_t2 = 1.0 - (1.0 - cos_i * cos_i) * (eta_eff * eta_eff)
    sign = jnp.where(cos_i >= 0.0, 1.0, -1.0)
    ok = cos_t2 > 0.0
    ct = jnp.sqrt(jnp.where(ok, cos_t2, 1.0))
    wt = (
        n * (-cos_i * eta_eff + sign * ct)[..., None]
        + wi * eta_eff[..., None]
    )
    return jnp.where(ok[..., None], wt, 0.0)


def fresnel(cos_theta_i, ext_ior, int_ior):
    """Unpolarized dielectric Fresnel (common.cpp:447-476)."""
    enter = cos_theta_i >= 0.0
    eta_i = jnp.where(enter, ext_ior, int_ior)
    eta_t = jnp.where(enter, int_ior, ext_ior)
    ci = jnp.abs(cos_theta_i)
    eta = eta_i / eta_t
    sin_t2 = eta * eta * (1.0 - ci * ci)
    ok = sin_t2 < 1.0
    # substituted sqrt argument on TIR lanes: see refract() NaN note
    ct = jnp.sqrt(jnp.where(ok, 1.0 - sin_t2, 1.0))
    rs = (eta_i * ci - eta_t * ct) / (eta_i * ci + eta_t * ct)
    rp = (eta_t * ci - eta_i * ct) / (eta_t * ci + eta_i * ct)
    f = 0.5 * (rs * rs + rp * rp)
    f = jnp.where(ok, f, 1.0)
    return jnp.where(ext_ior == int_ior, 0.0, f)


def fresnel_dielectric(cos_theta_i, eta):
    """fresnelDielectric with cosThetaT out (common.cpp:491-517).

    Returns (F, cos_theta_t); eta = int_ior/ext_ior.
    """
    scale = jnp.where(cos_theta_i > 0.0, 1.0 / eta, eta)
    cos_t2 = 1.0 - (1.0 - cos_theta_i * cos_theta_i) * (scale * scale)
    ci = jnp.abs(cos_theta_i)
    ok = cos_t2 > 0.0
    # substituted sqrt argument on TIR lanes: see refract() NaN note
    ct = jnp.sqrt(jnp.where(ok, cos_t2, 1.0))
    rs = (ci - eta * ct) / (ci + eta * ct)
    rp = (eta * ci - ct) / (eta * ci + ct)
    f = jnp.where(ok, 0.5 * (rs * rs + rp * rp), 1.0)
    cos_theta_t = jnp.where(
        ok, jnp.where(cos_theta_i > 0.0, -ct, ct), 0.0
    )
    return f, cos_theta_t


def spherical_direction(theta, phi):
    st, ct = jnp.sin(theta), jnp.cos(theta)
    sp, cp = jnp.sin(phi), jnp.cos(phi)
    return vec3(st * cp, st * sp, ct)


def spherical_coordinates(v):
    theta = jnp.arccos(jnp.clip(v[..., 2], -1.0, 1.0))
    phi = jnp.arctan2(v[..., 1], v[..., 0])
    phi = jnp.where(phi < 0.0, phi + 2.0 * jnp.pi, phi)
    return theta, phi


# ---------------------------------------------------------------------------
# Color (common.cpp:352-395)
# ---------------------------------------------------------------------------


def to_srgb(c):
    return jnp.where(
        c <= 0.0031308, 12.92 * c, 1.055 * jnp.power(jnp.maximum(c, 1e-12), 1.0 / 2.4) - 0.055
    )


def to_linear_rgb(c):
    return jnp.where(
        c <= 0.04045, c / 12.92, jnp.power((jnp.maximum(c, 0.0) + 0.055) / 1.055, 2.4)
    )


def luminance(c):
    """getLuminance (common.cpp:393-395)."""
    return c[..., 0] * 0.212671 + c[..., 1] * 0.715160 + c[..., 2] * 0.072169
