"""Film: filtered splat accumulation as scatter-add (block.cpp:56-96 redesigned).

The reference splats each sample into a mutex-guarded tile with a
pre-tabulated separable filter (block.cpp:12-27, 56-85). Here the film is a
single (H, W, 4) accumulation buffer (RGB + filter weight); each camera
sample contributes a static KxK footprint of filter-weighted values via one
``scatter-add``. Invalid (NaN/negative) radiance is dropped, matching the
runtime guard at block.cpp:57-61. Filters are evaluated analytically instead
of from the 32-bin table -- exact rather than quantized weights.

Filters (rfilter.cpp:10-102): gaussian (default r=2 sigma=0.5), mitchell
(B=C=1/3, r=2), tent (r=1), box (r=0.5).
"""
from __future__ import annotations

import math as pymath

import jax.numpy as jnp
import numpy as np

from ..core import math as km


def filter_radius(static) -> float:
    """Per-kind radius: tent/box hard-code theirs (rfilter.cpp:77, 93)."""
    kind = static.rfilter_kind
    if kind == "tent":
        return 1.0
    if kind == "box":
        return 0.5
    return static.rfilter_radius


def filter_eval(static, x):
    """Filter value at (possibly negative) offset x, vectorized. Values
    outside the filter radius are zero (footprint bound, block.cpp:71-76)."""
    kind = static.rfilter_kind
    r = filter_radius(static)
    ax = jnp.abs(x)
    if kind == "gaussian":
        alpha = -1.0 / (2.0 * static.rfilter_stddev**2)
        val = jnp.maximum(0.0, jnp.exp(alpha * ax * ax) - pymath.exp(alpha * r * r))
    elif kind == "mitchell":
        b, c = static.rfilter_b, static.rfilter_c
        x2 = 2.0 * ax / r
        x2sq = x2 * x2
        inner = (
            (12.0 - 9.0 * b - 6.0 * c) * x2 * x2sq
            + (-18.0 + 12.0 * b + 6.0 * c) * x2sq
            + (6.0 - 2.0 * b)
        ) * (1.0 / 6.0)
        outer = (
            (-b - 6.0 * c) * x2 * x2sq
            + (6.0 * b + 30.0 * c) * x2sq
            + (-12.0 * b - 48.0 * c) * x2
            + (8.0 * b + 24.0 * c)
        ) * (1.0 / 6.0)
        val = jnp.where(x2 < 1.0, inner, jnp.where(x2 < 2.0, outer, 0.0))
    elif kind == "tent":
        val = jnp.maximum(0.0, 1.0 - ax)
    elif kind == "box":
        val = jnp.ones_like(ax)
    else:
        raise ValueError(f"unknown rfilter {kind}")
    return jnp.where(ax <= r, val, 0.0)


def make_film(static):
    return jnp.zeros((static.height, static.width, 4), jnp.float32)


def splat(static, film, px, py, jitter, value):
    """Accumulate one batch of samples (block.cpp:56-85) at any lane
    layout.

    px, py: (N,) integer pixel of each sample; jitter: (N, 2) sub-pixel
    position in [0, 1); value: (N, 3). The footprint is placed from the
    integer pixel and the filter weights are ``splat_grid``'s, so both
    splats give a sample the same pixels and weights. (The f32 sum
    ``px + jitter`` would not: from x = 1024 on it rounds to a whole number
    for jitter within ~6e-5 of 0 or 1, which moves the sample onto a pixel
    edge, where a box filter credits it to two pixels.)
    """
    # Invalid-radiance guard (block.cpp:57-61)
    ok = jnp.all(jnp.isfinite(value) & (value >= 0.0), axis=-1)
    value = jnp.where(ok[:, None], value, 0.0)
    contrib = jnp.concatenate([value, jnp.ones_like(value[:, :1])], axis=-1)
    jx = jitter[:, 0] - 0.5
    jy = jitter[:, 1] - 0.5
    px = px.astype(jnp.int32)
    py = py.astype(jnp.int32)
    r = filter_radius(static)
    d_lo = int(np.ceil(-(r + 0.5)))
    d_hi = int(np.floor(r + 0.5))

    # One (N, 4) scatter-add per static footprint offset: keeps every
    # intermediate at (N, 4)/(N,) instead of a (N, k, k, 4) tensor.
    film_flat = film.reshape(-1, 4)
    for dy in range(d_lo, d_hi + 1):
        ys = py + dy
        wy = filter_eval(static, dy - jy)
        wy = jnp.where((ys >= 0) & (ys < static.height), wy, 0.0)
        yi = jnp.clip(ys, 0, static.height - 1)
        for dx in range(d_lo, d_hi + 1):
            xs = px + dx
            wx = filter_eval(static, dx - jx)
            wx = jnp.where((xs >= 0) & (xs < static.width), wx, 0.0)
            xi = jnp.clip(xs, 0, static.width - 1)
            w = (wx * wy)[:, None]
            idx = yi * static.width + xi
            film_flat = film_flat.at[idx].add(contrib * w)
    return film_flat.reshape(film.shape)


def _shift2d(a, dy: int, dx: int):
    """Static zero-fill shift: out[y+dy, x+dx] = a[y, x]."""
    h, w = a.shape[:2]
    out = jnp.zeros_like(a)
    ys_dst = slice(max(0, dy), h + min(0, dy))
    xs_dst = slice(max(0, dx), w + min(0, dx))
    ys_src = slice(max(0, -dy), h + min(0, -dy))
    xs_src = slice(max(0, -dx), w + min(0, -dx))
    return out.at[ys_dst, xs_dst].set(a[ys_src, xs_src])


def splat_grid(static, film, jitter, value):
    """Scatter-free splat for the ordered full-pixel-grid lane layout (one
    lane per pixel, row-major): every filter-footprint offset becomes a
    static 2D shift + add, which XLA fuses into plain vector code instead
    of a scatter-add with duplicate indices. (Whether the GPU's atomic
    scatter-add would be faster is not measured yet.)

    jitter: (N, 2) sub-pixel positions in [0,1); value: (N, 3).
    """
    h, w = static.height, static.width
    ok = jnp.all(jnp.isfinite(value) & (value >= 0.0), axis=-1)
    value = jnp.where(ok[:, None], value, 0.0)
    contrib = jnp.concatenate(
        [value, jnp.ones_like(value[:, :1])], axis=-1
    ).reshape(h, w, 4)
    # px - x = jitter - 0.5 for every lane
    jx = (jitter[:, 0] - 0.5).reshape(h, w)
    jy = (jitter[:, 1] - 0.5).reshape(h, w)
    r = filter_radius(static)
    d_lo = int(np.ceil(-(r + 0.5)))
    d_hi = int(np.floor(r + 0.5))
    for dy in range(d_lo, d_hi + 1):
        wy = filter_eval(static, dy - jy)
        for dx in range(d_lo, d_hi + 1):
            wx = filter_eval(static, dx - jx)
            film = film + _shift2d(contrib * (wx * wy)[..., None], dy, dx)
    return film


def to_bitmap(film):
    """Divide accumulated RGB by filter weight (block.cpp:39-45)."""
    w = film[..., 3:4]
    return jnp.where(w > 0.0, film[..., :3] / jnp.maximum(w, 1e-9), 0.0)


def to_srgb8(img):
    return np.asarray(
        jnp.clip(km.to_srgb(jnp.clip(img, 0.0, 1.0)) * 255.0 + 0.5, 0, 255)
    ).astype(np.uint8)


def splat_grid_band(static, jitter, value):
    """splat_grid for a contiguous row band of the pixel grid (lanes = a
    whole number of rows in row-major order): returns the border-padded
    (rows + 2B, W, 4) band accumulation; ``accumulate_band`` adds it into
    the film at the band's row offset with static slices. Chunked passes
    keep the scatter-free splat this way, and the band shape is
    chunk-position independent, so one compiled pass serves all chunks.
    Bit-identical to splat_grid over the full grid."""
    w = static.width
    n = value.shape[0]
    rows = n // w
    ok = jnp.all(jnp.isfinite(value) & (value >= 0.0), axis=-1)
    value = jnp.where(ok[:, None], value, 0.0)
    contrib = jnp.concatenate(
        [value, jnp.ones_like(value[:, :1])], axis=-1
    ).reshape(rows, w, 4)
    jx = (jitter[:, 0] - 0.5).reshape(rows, w)
    jy = (jitter[:, 1] - 0.5).reshape(rows, w)
    r = filter_radius(static)
    d_lo = int(np.ceil(-(r + 0.5)))
    d_hi = int(np.floor(r + 0.5))
    B = band_border(static)
    bh = rows + 2 * B
    band = jnp.zeros((bh, w, 4), jnp.float32)

    def pad(a):
        return jnp.zeros((bh, w), a.dtype).at[B : B + rows].set(a)

    contrib_b = jnp.zeros((bh, w, 4), jnp.float32).at[B : B + rows].set(
        contrib
    )
    jx_b = pad(jx)
    jy_b = pad(jy)
    for dy in range(d_lo, d_hi + 1):
        wy = filter_eval(static, dy - jy_b)
        for dx in range(d_lo, d_hi + 1):
            wx = filter_eval(static, dx - jx_b)
            band = band + _shift2d(contrib_b * (wx * wy)[..., None], dy, dx)
    return band


def band_border(static) -> int:
    """Border rows of a splat band (max filter-footprint shift)."""
    r = filter_radius(static)
    return max(
        int(np.floor(r + 0.5)), -int(np.ceil(-(r + 0.5)))
    )


def accumulate_band(static, film, band, row0: int):
    """Add a splat band (from splat_grid_band) into the film at rows
    [row0 - B, row0 + rows + B), clipped to the image."""
    h = static.height
    B = band_border(static)
    bh = band.shape[0]
    y0 = row0 - B
    lo = max(0, -y0)
    hi = bh - max(0, y0 + bh - h)
    return film.at[y0 + lo : y0 + hi].add(band[lo:hi])
