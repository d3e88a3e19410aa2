"""SPMD sharding: the replacement for the reference's TBB tile pool
(renderer.cpp:94-127, SURVEY §2.8).

Model: one ``Mesh`` over all chips with a single ``'devices'`` axis; pixel
lanes are sharded along it, the scene (geometry, BVH, materials, textures,
light tables) is replicated, and the film is produced as a global
scatter-add -- XLA partitions the computation and inserts the all-reduce for
the film (and for parameter gradients in the inverse-rendering step). No
locks, no tile queue: ownership is the sharding, determinism comes from the
counter-based sampler streams (§3.4), which are pixel-keyed and therefore
identical under any lane placement.
"""
from __future__ import annotations

from functools import lru_cache, partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core import rng
from ..film import film as film_mod
from ..integrate import camera as camera_mod
from ..integrate.path_mis import li_wavefront
from ..samplers import streams


def make_mesh(devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), ("devices",))


def _shard_map(f, mesh, in_specs, out_specs):
    # check_vma rejects scan carries that start replicated and become
    # device-varying (the wavefront's li/throughput lanes do); the film
    # psum at the end is the only cross-device dependency, so the check is
    # safely disabled rather than pcast-ing every carry leaf.
    return jax.shard_map(
        f, mesh=mesh, in_specs=in_specs, out_specs=out_specs, check_vma=False
    )


def jump_table(sample_indices):
    """(S, 4) u32 pcg jump constants for a set of sample indices -- the
    per-*lane* analog of render.py's per-pass host-computed jump (one lane
    batch can then carry several sample indices at once)."""
    rows = []
    for s in sample_indices:
        a, c = rng.advance_constants(int(s) * 65536)
        rows.append(
            [a >> 32, a & 0xFFFFFFFF, c >> 32, c & 0xFFFFFFFF]
        )
    return jnp.asarray(np.asarray(rows, np.uint64).astype(np.uint32))


def make_sample_lanes(static, n_dev, sample_batches=1):
    """Lane layout for the pixels x sample-batches axis (SURVEY §2.8's
    'sequence-parallel analog': sharding the sample dimension at fixed
    pixel count). Returns host arrays (px, py, batch) of equal length,
    padded to a multiple of n_dev; padded lanes target an off-image pixel
    (zero-weight splats)."""
    h, w = static.height, static.width
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    px = np.tile(xs.reshape(-1), sample_batches).astype(np.uint32)
    py = np.tile(ys.reshape(-1), sample_batches).astype(np.uint32)
    batch = np.repeat(
        np.arange(sample_batches, dtype=np.uint32), h * w
    )
    pad = (-len(px)) % n_dev
    if pad:
        px = np.concatenate([px, np.full(pad, 0x7FFFFF, np.uint32)])
        py = np.concatenate([py, np.zeros(pad, np.uint32)])
        batch = np.concatenate([batch, np.zeros(pad, np.uint32)])
    return px, py, batch


@lru_cache(maxsize=8)
def shard_mapped_pass(mesh: Mesh, static, spec):
    """One multi-sample render pass as an explicit shard_map: lanes
    (pixels x sample-batches) are sharded over 'devices', the scene is
    replicated, and every per-lane stage -- including the wavefront's
    per-bounce coherence permute (path_mis._bounce_ordered) -- runs
    *shard-local*, so XLA inserts no all-to-alls; the only collective is
    one film psum at the end (SURVEY §2.8: per-host compaction + film
    all-reduce). Returns a jitted fn(scene, px, py, si, jump_rows) -> film
    contribution (replicated). Cached, so repeated renders of one scene
    shape reuse the compiled pass."""
    from ..integrate.render import li_fn_for

    lane = P("devices")
    rep = P()

    def body(scene_arrays, px, py, si, jump_rows):
        jump = (
            (jump_rows[:, 0], jump_rows[:, 1]),
            (jump_rows[:, 2], jump_rows[:, 3]),
        )
        stream = streams.init_stream_jump(spec, px, py, si, jump)
        stream, jitter = streams.next_pixel_2d(spec, stream)
        pixel_sample = jnp.stack([px, py], -1).astype(jnp.float32) + jitter
        stream, aperture = streams.next_2d(spec, stream)
        rays = camera_mod.sample_ray(scene_arrays, static, pixel_sample, aperture)
        _, li, _ = li_fn_for(static)(scene_arrays, static, spec, stream, rays)
        local = film_mod.splat(
            static, film_mod.make_film(static), px, py, jitter, li
        )
        return jax.lax.psum(local, "devices")

    return jax.jit(
        _shard_map(body, mesh, (rep, lane, lane, lane, lane), rep)
    )


def render_sample_sharded(
    mesh: Mesh,
    scene,
    static,
    spec=None,
    spp: Optional[int] = None,
    sample_batches: int = 1,
):
    """Full-frame render with the pixels x sample-batches lane axis sharded
    over the mesh via shard_map. ``sample_batches`` sample indices are
    rendered per pass (host loop covers the rest)."""
    if spec is None:
        from ..integrate.render import sampler_spec

        spec = sampler_spec(static)
    n_samples = spp if spp is not None else spec.effective_sample_count
    S = max(1, min(sample_batches, n_samples))
    px, py, batch = make_sample_lanes(static, mesh.size, S)
    lane_sharding = NamedSharding(mesh, P("devices"))
    px_d = jax.device_put(jnp.asarray(px), lane_sharding)
    py_d = jax.device_put(jnp.asarray(py), lane_sharding)
    batch_d = jax.device_put(jnp.asarray(batch), lane_sharding)

    run = shard_mapped_pass(mesh, static, spec)
    film = film_mod.make_film(static)
    for s0 in range(0, n_samples, S):
        idx = [min(s0 + b, n_samples - 1) for b in range(S)]
        jumps = jump_table(idx)  # (S, 4)
        si = jnp.asarray(s0, jnp.uint32) + batch_d
        jump_rows = jumps[batch_d]
        jump_rows = jax.device_put(jump_rows, lane_sharding)
        film = film + run(scene, px_d, py_d, si, jump_rows)
    return film_mod.to_bitmap(film)


def _pass_contributions(scene, static, spec, px, py, sample_index, jump):
    stream = streams.init_stream_jump(spec, px, py, sample_index, jump)
    stream, jitter = streams.next_pixel_2d(spec, stream)
    pixel_sample = jnp.stack([px, py], -1).astype(jnp.float32) + jitter
    stream, aperture = streams.next_2d(spec, stream)
    rays = camera_mod.sample_ray(scene, static, pixel_sample, aperture)
    from ..integrate.render import li_fn_for

    _, li, _ = li_fn_for(static)(scene, static, spec, stream, rays)
    return jitter, li


@lru_cache(maxsize=8)
def sharded_render_pass(mesh: Mesh, static, spec):
    """Builds a jitted one-sample render pass with pixel lanes sharded over
    the mesh and film/scene replicated. Lane count must be divisible by the
    device count (pad pixels to a multiple). Cached like
    ``shard_mapped_pass``."""
    lane_sharding = NamedSharding(mesh, P("devices"))
    repl = NamedSharding(mesh, P())

    @partial(
        jax.jit,
        static_argnames=(),
        in_shardings=(repl, repl, lane_sharding, lane_sharding, None, None),
        out_shardings=repl,
    )
    def run(scene_arrays, film, px, py, sample_index, jump):
        jitter, li = _pass_contributions(
            scene_arrays, static, spec, px, py, sample_index, jump
        )
        return film_mod.splat(static, film, px, py, jitter, li)

    return run


def render_distributed(
    mesh: Mesh, scene, static, spec=None, spp: Optional[int] = None
):
    """Full-frame render with pixels sharded over the mesh."""
    if spec is None:
        from ..integrate.render import sampler_spec

        spec = sampler_spec(static)
    n_samples = spp if spp is not None else spec.effective_sample_count
    h, w = static.height, static.width
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    px = xs.reshape(-1).astype(np.uint32)
    py = ys.reshape(-1).astype(np.uint32)
    n_dev = mesh.size
    pad = (-len(px)) % n_dev
    if pad:
        # padded lanes target an off-image pixel: zero-weight splats
        px = np.concatenate([px, np.full(pad, 0x7FFFFF, np.uint32)])
        py = np.concatenate([py, np.zeros(pad, np.uint32)])

    run = sharded_render_pass(mesh, static, spec)
    lane_sharding = NamedSharding(mesh, P("devices"))
    px_d = jax.device_put(jnp.asarray(px), lane_sharding)
    py_d = jax.device_put(jnp.asarray(py), lane_sharding)
    film = film_mod.make_film(static)
    for s in range(n_samples):
        a, c = rng.advance_constants(s * 65536)
        jump = (
            (jnp.uint32(a >> 32), jnp.uint32(a & 0xFFFFFFFF)),
            (jnp.uint32(c >> 32), jnp.uint32(c & 0xFFFFFFFF)),
        )
        film = run(scene, film, px_d, py_d, jnp.uint32(s), jump)
    return film_mod.to_bitmap(film)


def inverse_train_step(mesh: Mesh, scene, static, spec):
    """Differentiable sharded step: L2 image loss against a target, with
    gradients w.r.t. the material table + texel pool (the inverse-rendering
    parameter set). Gradients are produced replicated -- XLA all-reduces the
    per-device partial gradients (grad-of-psum structure)."""
    lane_sharding = NamedSharding(mesh, P("devices"))
    repl = NamedSharding(mesh, P())

    @partial(
        jax.jit,
        in_shardings=(
            repl,
            repl,
            lane_sharding,
            lane_sharding,
            None,
            None,
        ),
        out_shardings=(repl, repl),
    )
    def step(scene_arrays, target, px, py, sample_index, jump):
        def loss_fn(params):
            texels = params.pop("texels")
            sc = scene_arrays._replace(
                materials=scene_arrays.materials._replace(**params),
                textures=scene_arrays.textures._replace(texels=texels),
            )
            film = film_mod.make_film(static)
            jitter, li = _pass_contributions(
                sc, static, spec, px, py, sample_index, jump
            )
            film = film_mod.splat(static, film, px, py, jitter, li)
            img = film_mod.to_bitmap(film)
            return jnp.mean((img - target) ** 2)

        params = dict(material_float_params(scene_arrays.materials))
        params["texels"] = scene_arrays.textures.texels
        loss, grads = jax.value_and_grad(loss_fn)(params)
        return loss, grads

    return step


MATERIAL_FLOAT_FIELDS = (
    "base_color",
    "metallic",
    "roughness",
    "anisotropy",
    "specular",
    "specular_tint",
    "clearcoat",
    "clearcoat_roughness",
    "sheen",
    "sheen_tint",
    "int_ior",
    "ext_ior",
    "alpha",
    "eta_c",
    "k_c",
)


def material_float_params(materials):
    """The differentiable subset of the material table."""
    return {k: getattr(materials, k) for k in MATERIAL_FLOAT_FIELDS}
