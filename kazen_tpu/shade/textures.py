"""Texture evaluation over the flat texel pool.

The reference uses OIIO's lazy TextureSystem (texture.cpp:46-98); here all
textures are device-resident up front (SURVEY §2.7) and lookups are bilinear
gathers with periodic wrap and the reference's v-flip + uv-scale conventions
(texture.cpp:55: st = (u*scale, (1-v)*scale)). sRGB->linear conversion is
applied at load time by the scene compiler (the reference converts after
filtering; linearize-then-filter is the more correct order and the diff is
sub-quantization for 8-bit sources). Gathers are differentiable w.r.t. the
texel pool (adjoint = scatter-add), which the inverse-rendering path uses.
"""
from __future__ import annotations

import jax.numpy as jnp

from ..core import math as km


def _bilinear_wh(pool, off, w, h, x, y):
    """Bilinear fetch at continuous pixel coords (x, y) with periodic wrap,
    explicit (offset, width, height) so mip levels share the code."""
    x = x - 0.5
    y = y - 0.5
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0i = jnp.mod(x0.astype(jnp.int32), w)
    x1i = jnp.mod(x0.astype(jnp.int32) + 1, w)
    y0i = jnp.mod(y0.astype(jnp.int32), h)
    y1i = jnp.mod(y0.astype(jnp.int32) + 1, h)
    c00 = pool.texels[off + y0i * w + x0i]
    c10 = pool.texels[off + y0i * w + x1i]
    c01 = pool.texels[off + y1i * w + x0i]
    c11 = pool.texels[off + y1i * w + x1i]
    return (
        c00 * (1 - fx) * (1 - fy)
        + c10 * fx * (1 - fy)
        + c01 * (1 - fx) * fy
        + c11 * fx * fy
    )


def _bilinear(pool, tid, x, y):
    return _bilinear_wh(
        pool, pool.offset[tid], pool.width[tid], pool.height[tid], x, y
    )


def _bilinear_level(pool, tid, u, v, level):
    """Bilinear at mip level (integer, per-lane); level-l size is
    max(1, w >> l) x max(1, h >> l) at pool.mip_offset[tid, l]."""
    w = jnp.maximum(jnp.right_shift(pool.width[tid], level), 1)
    h = jnp.maximum(jnp.right_shift(pool.height[tid], level), 1)
    off = jnp.take_along_axis(
        pool.mip_offset[tid], level[..., None], axis=-1
    )[..., 0]
    return _bilinear_wh(
        pool, off, w, h, u * w.astype(jnp.float32), v * h.astype(jnp.float32)
    )


N_ANISO_PROBES = 4  # texture probes along the footprint's major axis


def _eval_leaf(pool, tid, uv, lod=None, aniso=None):
    """Image bilinear (trilinear across the mip chain when ``lod`` is
    given) or constant; composite -> 0. ``lod`` is log2 of the uv-space
    footprint; the per-texture texel level adds log2(resolution*scale).
    With ``aniso`` (the major uv half-axis from
    path_mis._texture_footprint), the lookup averages N_ANISO_PROBES
    trilinear probes spread along the major axis at the minor-axis mip
    level -- EWA-style anisotropic minification (the reference gets this
    from OIIO, texture.cpp:46-64). A zero half-axis degenerates to one
    probe position, i.e. plain trilinear."""
    from ..scene.compiler import TEX_CONSTANT, TEX_IMAGE

    scale = pool.uv_scale[tid]
    if lod is None:
        u = uv[..., 0] * scale
        v = (1.0 - uv[..., 1]) * scale
        w = pool.width[tid].astype(jnp.float32)
        h = pool.height[tid].astype(jnp.float32)
        img = _bilinear(pool, tid, u * w, v * h)
    else:
        # OIIO-style filtered minification (texture.cpp:46-64): clamp the
        # level of detail to the texture's chain, trilinear between the
        # two bracketing levels
        res = jnp.maximum(pool.width[tid], pool.height[tid]).astype(
            jnp.float32
        )
        lam = lod + jnp.log2(res * jnp.maximum(scale, 1e-9))
        max_l = (pool.n_levels[tid] - 1).astype(jnp.float32)
        lam = jnp.clip(lam, 0.0, max_l)
        l0 = jnp.floor(lam).astype(jnp.int32)
        l1 = jnp.minimum(l0 + 1, pool.n_levels[tid] - 1)
        f = (lam - l0.astype(jnp.float32))[..., None]

        def trilinear(uv2):
            u = uv2[..., 0] * scale
            v = (1.0 - uv2[..., 1]) * scale
            return (1.0 - f) * _bilinear_level(pool, tid, u, v, l0) + (
                f * _bilinear_level(pool, tid, u, v, l1)
            )

        if aniso is None:
            img = trilinear(uv)
        else:
            np_ = N_ANISO_PROBES
            img = 0.0
            for i in range(np_):
                t = 2.0 * i / (np_ - 1) - 1.0  # [-1, 1]
                img = img + trilinear(uv + t * aniso)
            img = img / np_
    tt = pool.ttype[tid]
    val = jnp.where((tt == TEX_IMAGE)[..., None], img, 0.0)
    return jnp.where(
        (tt == TEX_CONSTANT)[..., None], pool.const_color[tid], val
    )


def _combine(pool, tid, uv, child_eval):
    """One composite level: colorramp/blend over child_eval(node_id)."""
    from ..scene.compiler import (
        TEX_BLEND_MIX,
        TEX_BLEND_MULTIPLY,
        TEX_COLORRAMP,
    )

    tt = pool.ttype[tid]
    base = child_eval(tid)

    in1_id = pool.input1[tid]
    in2_id = pool.input2[tid]
    mask_id = pool.mask_id[tid]
    in1 = child_eval(jnp.maximum(in1_id, 0))
    in2 = child_eval(jnp.maximum(in2_id, 0))
    mask = child_eval(jnp.maximum(mask_id, 0))

    # colorramp (texture.cpp:160-170): per-channel min+(max-min)*clamp(c);
    # missing nested -> 0
    ramped = pool.ramp_min[tid][..., None] + (
        pool.ramp_max[tid] - pool.ramp_min[tid]
    )[..., None] * jnp.clip(in1, 0.0, 1.0)
    ramped = jnp.where((in1_id >= 0)[..., None], ramped, 0.0)

    # blend defaults (texture.cpp:208-216): mask=0.5, in1=0, in2=1
    b_in1 = jnp.where((in1_id >= 0)[..., None], in1, 0.0)
    b_in2 = jnp.where((in2_id >= 0)[..., None], in2, 1.0)
    b_mask = jnp.where((mask_id >= 0)[..., None], mask, 0.5)[..., 0:1]
    mixed = (1.0 - b_mask) * b_in1 + b_mask * b_in2
    multiplied = b_in1 * b_in2

    out = base
    out = jnp.where((tt == TEX_COLORRAMP)[..., None], ramped, out)
    out = jnp.where((tt == TEX_BLEND_MIX)[..., None], mixed, out)
    out = jnp.where((tt == TEX_BLEND_MULTIPLY)[..., None], multiplied, out)
    return out


def eval_texture(static, pool, tex_id, uv, const_color, lod=None):
    """Texture<Color3f>::eval(uv) over the texture graph: image lookup or
    up-to-two composite levels where tex_id >= 0, else the per-lane
    constant color. ``lod``: per-lane log2 uv-footprint for mip selection
    (None = exact level-0 bilinear, the oracle-parity mode). A (N, 3) uv
    carries the lod in its third column; a (N, 5) uv additionally carries
    the EWA-style anisotropic major uv half-axis in columns 3:5 -- the
    convention ShadeCtx uses to thread the footprint through the BSDF
    fetch sites unchanged."""
    aniso = None
    if uv.shape[-1] >= 3:
        if lod is None:
            lod = uv[..., 2]
        if uv.shape[-1] >= 5:
            aniso = uv[..., 3:5]
        uv = uv[..., :2]
    if not getattr(static, "mip_textures", False):
        lod = None
        aniso = None
    tid = jnp.maximum(tex_id, 0)
    if not static.has_composite_textures and not static.has_image_textures:
        # only constant nodes exist: composite/image paths compile away
        val = pool.const_color[tid]
    elif not static.has_composite_textures:
        val = _eval_leaf(pool, tid, uv, lod, aniso)
    else:
        level1 = lambda nid: _combine(
            pool, nid, uv,
            lambda cid: _eval_leaf(pool, cid, uv, lod, aniso),
        )
        val = _combine(pool, tid, uv, level1)
    return jnp.where((tex_id >= 0)[..., None], val, const_color)


def eval_texture_dir(static, pool, tex_id, d, const_color, lod=None):
    """Directional (environment) lookup: Blinn/Newell lat-long mapping, the
    convention intended by the reference (scene.cpp:58-63 commented block /
    OIIO environment): u = (atan2(x, z) + pi) / 2pi, v = (asin(y) + pi/2)/pi.
    ``lod``: log2 uv-footprint for mip-filtered env lookups (the OIIO
    environment() call filters too); None = level-0 bilinear.
    """
    u = (jnp.arctan2(d[..., 0], d[..., 2]) + jnp.pi) * km.INV_TWOPI
    v = (jnp.arcsin(jnp.clip(d[..., 1], -1.0, 1.0)) + 0.5 * jnp.pi) * km.INV_PI
    uv = jnp.stack([u, v], -1)
    return eval_texture(static, pool, tex_id, uv, const_color, lod=lod)
