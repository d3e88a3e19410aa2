"""Camera ray generation (camera.cpp:70-91 perspective, :188-226 thinlens),
batched over samples. Points go through the homogeneous transform with
perspective divide (transform.h:58-62); directions use the rotation part.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core import math as km
from ..core import warp
from ..accel.intersect import Rays


# full f32 products: a GPU may otherwise run f32 matmuls in TF32, which
# would move every camera ray by ~1e-3
_HIGHEST = jax.lax.Precision.HIGHEST


def _xform_point(m, p):
    r = jnp.dot(p, m[:3, :3].T, precision=_HIGHEST) + m[:3, 3]
    w = jnp.dot(p, m[3, :3], precision=_HIGHEST) + m[3, 3]
    return r / w[..., None]


def _xform_vector(m, v):
    return jnp.dot(v, m[:3, :3].T, precision=_HIGHEST)


def sample_ray(scene, static, pixel_sample, aperture_sample) -> Rays:
    """Returns world-space camera rays; importance weight is 1 for both
    camera models (camera.cpp:92, :227)."""
    inv_size = jnp.asarray(
        [1.0 / static.width, 1.0 / static.height], jnp.float32
    )
    p_sample = pixel_sample * inv_size
    near_p = _xform_point(
        scene.sample_to_camera,
        jnp.concatenate([p_sample, jnp.zeros_like(p_sample[..., :1])], -1),
    )

    if static.camera_kind == "thinlens":
        tmp = warp.square_to_uniform_disk(aperture_sample) * scene.aperture_radius
        aperture_p = jnp.concatenate(
            [tmp, jnp.zeros_like(tmp[..., :1])], axis=-1
        )
        focus_p = near_p * (scene.focus_distance / near_p[..., 2:3])
        d_local = km.normalize(focus_p - aperture_p)
        o_local = aperture_p
    else:
        d_local = km.normalize(near_p)
        o_local = jnp.zeros_like(near_p)

    inv_z = 1.0 / d_local[..., 2]
    o = _xform_point(scene.cam_to_world, o_local)
    d = _xform_vector(scene.cam_to_world, d_local)
    return Rays(
        o=o,
        d=d,
        mint=scene.cam_near * inv_z,
        maxt=scene.cam_far * inv_z,
    )
