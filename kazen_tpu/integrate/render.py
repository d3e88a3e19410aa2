"""Top-level render driver: the analog of renderer::render
(renderer.cpp:72-153). The spiral tile scheduler becomes a static pixel
batch; spp becomes a host loop of jitted sample passes (one compile total --
the per-sample pcg jump constants are traced inputs); the film is a single
scatter-add accumulation buffer.
"""
from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core import rng
from ..film import film as film_mod
from ..samplers.streams import SamplerSpec
from . import camera as camera_mod
from .path_mis import li_wavefront


def li_fn_for(static):
    if static.integrator_kind == "path_mis":
        return li_wavefront
    from .simple import LI_FNS

    return LI_FNS[static.integrator_kind]


def sampler_spec(static) -> SamplerSpec:
    if static.sampler_kind == "pmj02bn":
        from ..samplers.tables import make_pmj02bn_spec

        return make_pmj02bn_spec(static.sample_count, static.seed)
    return SamplerSpec(
        kind=static.sampler_kind,
        sample_count=static.sample_count,
        seed=static.seed,
    )


@partial(jax.jit, static_argnames=("static", "spec", "grid_splat"))
def _render_pass(
    scene, static, spec, film, px, py, sample_index, jump, grid_splat=True
):
    """One sample-per-pixel pass over a lane batch of pixels. With
    ``grid_splat`` the lanes must be the full pixel grid in row-major order
    (the normal layout) and the film splat uses static shifts instead of
    scatter-add."""
    from ..samplers import streams

    stream = streams.init_stream_jump(spec, px, py, sample_index, jump)
    # renderSample (renderer.cpp:20-40): pixel jitter then aperture draw
    stream, jitter = streams.next_pixel_2d(spec, stream)
    pixel_sample = (
        jnp.stack([px, py], -1).astype(jnp.float32) + jitter
    )
    stream, aperture = streams.next_2d(spec, stream)
    rays = camera_mod.sample_ray(scene, static, pixel_sample, aperture)
    _, li, nrays = li_fn_for(static)(scene, static, spec, stream, rays)
    if grid_splat:
        return film_mod.splat_grid(static, film, jitter, li), nrays
    return film_mod.splat(static, film, px, py, jitter, li), nrays


def render(
    scene,
    static,
    spec: Optional[SamplerSpec] = None,
    spp: Optional[int] = None,
    lane_chunk: Optional[int] = None,
    verbose: bool = False,
    metrics=None,
):
    """Render the full frame; returns the (H, W, 3) linear image.

    With ``verbose`` prints an ETA progress line; pass a
    utils.metrics.RenderMetrics to collect per-pass rays/s."""
    if spec is None:
        spec = sampler_spec(static)
    n_samples = spp if spp is not None else spec.effective_sample_count

    h, w = static.height, static.width
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    px_all = jnp.asarray(xs.reshape(-1).astype(np.uint32))
    py_all = jnp.asarray(ys.reshape(-1).astype(np.uint32))

    chunks = [(px_all, py_all)]
    if lane_chunk is not None and px_all.shape[0] > lane_chunk:
        n = px_all.shape[0]
        pad = (-n) % lane_chunk
        px_pad = jnp.pad(px_all, (0, pad), constant_values=0)
        py_pad = jnp.pad(py_all, (0, pad), constant_values=0)
        # padded duplicate lanes re-render pixel (0,0) sample streams; their
        # splats land on real pixels, so instead mask them out via weight-0
        # contributions by pushing them off-image.
        px_pad = px_pad.at[n:].set(jnp.uint32(0x7FFFFF))
        chunks = [
            (px_pad[i : i + lane_chunk], py_pad[i : i + lane_chunk])
            for i in range(0, n + pad, lane_chunk)
        ]

    progress = None
    if verbose:
        from ..utils.metrics import Progress

        progress = Progress(n_samples)
    film = film_mod.make_film(static)
    import time as _time

    for s in range(n_samples):
        t0 = _time.time()
        a, c = rng.advance_constants(s * 65536)
        jump = (
            (jnp.uint32(a >> 32), jnp.uint32(a & 0xFFFFFFFF)),
            (jnp.uint32(c >> 32), jnp.uint32(c & 0xFFFFFFFF)),
        )
        nrays_total = 0.0
        for px, py in chunks:
            film, nrays = _render_pass(
                scene, static, spec, film, px, py, jnp.uint32(s), jump,
                grid_splat=(len(chunks) == 1),
            )
            if metrics is not None:
                nrays_total += float(nrays)
        if metrics is not None:
            from ..utils.metrics import PassMetrics

            jax.block_until_ready(film)
            metrics.add(
                PassMetrics(
                    sample_index=s,
                    seconds=_time.time() - t0,
                    rays=nrays_total,
                    lanes=int(px_all.shape[0]),
                )
            )
        if progress is not None:
            progress.update(s + 1)
    return film_mod.to_bitmap(film)
