"""kazen-con-2 feature behaviors: light primary visibility + punch-through,
roughness-bias regularization, configurable trace bias, Hanika terminator
offset, thin-lens camera."""
import numpy as np
import jax.numpy as jnp

import scenes
from kazen_tpu.scene import description as D
from kazen_tpu.scene.compiler import compile_scene
from kazen_tpu.integrate.render import render


def _render(scene, spp=4):
    arrays, static = compile_scene(scene, use_bvh=False)
    return np.asarray(render(arrays, static, spp=spp))


def _light_pixels(width=24, height=24):
    """Rough image region where the light quad is directly visible."""
    # camera at (0,1,-2.5) looking +z; light at ceiling center
    return slice(0, height // 3), slice(width // 3, 2 * width // 3)


def test_light_primary_visibility():
    vis = scenes.cornell_box(
        width=24, height=24, spp=4,
        light_kwargs=dict(intensity=20.0, primary_visibility=True),
    )
    invis = scenes.cornell_box(
        width=24, height=24, spp=4,
        light_kwargs=dict(intensity=20.0, primary_visibility=False),
    )
    img_v = _render(vis)
    img_i = _render(invis)
    # the visible-light render contains direct-radiance (=20) pixels
    assert img_v.max() > 15.0
    # the invisible-light render must NOT (punch-through removes them)
    assert img_i.max() < 5.0
    # indirect illumination remains comparable
    mask = img_v < 5.0
    np.testing.assert_allclose(
        img_v[mask].mean(), img_i[mask].mean(), rtol=0.15
    )


def test_regularization_accumulates_and_biases():
    """accumulatedRoughness grows by regularize(uv)*scale per bounce
    (integrator.cpp:297-301) and biases kiss eval/pdf roughness."""
    # unit level: accumulation reaches the BSDF as a roughness increase
    from kazen_tpu.core import math as km
    from kazen_tpu.shade import bsdf as bsdf_mod

    scene = scenes.cornell_box(
        width=8, height=8, spp=1,
        wall_bsdf=D.KazenStandard(roughness=D.ConstantTexture((0.1,) * 3)),
    )
    arrays, static = compile_scene(scene, use_bvh=False)
    n = 256
    uv = jnp.full((n, 2), 0.5)
    mat = jnp.zeros(n, jnp.int32)
    frame = km.frame_from_normal(
        jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0]), (n, 3))
    )
    wi = km.normalize(jnp.broadcast_to(jnp.asarray([0.4, 0.0, 0.9]), (n, 3)))
    wo = km.normalize(jnp.broadcast_to(jnp.asarray([-0.4, 0.1, 0.9]), (n, 3)))
    reg = bsdf_mod.regularize_resolved(static, arrays, mat, uv)
    np.testing.assert_allclose(np.asarray(reg), 0.1, atol=1e-6)
    f0 = bsdf_mod.eval(
        static, arrays, mat, uv, frame, frame.s, wi, wo, jnp.zeros(n)
    )
    f1 = bsdf_mod.eval(
        static, arrays, mat, uv, frame, frame.s, wi, wo, jnp.full(n, 0.5)
    )
    # extra roughness flattens the specular lobe away from the peak
    assert not np.allclose(np.asarray(f0), np.asarray(f1))

    # image level: enabling regularization changes the render, stays finite
    kw = dict(
        width=16, height=16, spp=8, max_depth=5,
        wall_bsdf=D.KazenStandard(
            base_color=D.ConstantTexture((0.7,) * 3),
            roughness=D.ConstantTexture((0.15,) * 3),
            metallic=D.ConstantTexture((0.6,) * 3),
        ),
        light_kwargs=dict(intensity=40.0),
    )
    img0 = _render(scenes.cornell_box(regularization=False, **kw), spp=8)
    img1 = _render(scenes.cornell_box(regularization=True, **kw), spp=8)
    assert np.isfinite(img1).all()
    assert np.abs(img0 - img1).max() > 1e-3


def test_trace_bias_respected():
    """A huge trace bias visibly changes shadowing (bias is plumbed)."""
    s_small = scenes.cornell_box(width=16, height=16, spp=4)
    s_small.integrator.trace_bias = 1e-3
    s_big = scenes.cornell_box(width=16, height=16, spp=4)
    s_big.integrator.trace_bias = 0.5
    img_a = _render(s_small)
    img_b = _render(s_big)
    assert np.abs(img_a - img_b).max() > 0.01


def test_hanika_offset_applied():
    """With vertex normals bent away from geometric, the hit point moves off
    the true surface plane toward the normal-consistent offset point."""
    from kazen_tpu.accel.intersect import Rays, intersect_brute
    from kazen_tpu.shade.interaction import prepare

    v = np.array(
        [[-1, 0, -1], [1, 0, -1], [1, 0, 1], [-1, 0, 1]], np.float32
    )
    f = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    bent = np.array([0.5, 1.0, 0.0], np.float32)
    bent /= np.linalg.norm(bent)
    n = np.tile(bent, (4, 1)).astype(np.float32)
    scene = D.Scene(
        meshes=[D.Mesh(vertices=v, faces=f, normals=n)],
        camera=D.PerspectiveCamera(width=4, height=4),
    )
    arrays, static = compile_scene(scene, use_bvh=False)
    o = jnp.asarray([[0.3, 1.0, 0.2]])
    d = jnp.asarray([[0.0, -1.0, 0.0]])
    rays = Rays(o=o, d=d, mint=jnp.zeros(1), maxt=jnp.full(1, 100.0))
    hit = intersect_brute(arrays, rays)
    its = prepare(arrays, rays, hit)
    assert bool(hit.valid[0])
    # plain hit would be y == 0; Hanika offset moves it off the plane
    assert abs(float(its.p[0, 1])) > 1e-4


def test_thinlens_depth_of_field():
    """Thin-lens blurs out-of-focus geometry relative to pinhole."""
    def cam(kind):
        if kind == "pinhole":
            return D.PerspectiveCamera(
                width=24, height=24, fov=60.0,
                to_world=D.lookat([0, 1, -2.5], [0, 1, 0], [0, 1, 0]),
            )
        return D.ThinlensCamera(
            width=24, height=24, fov=60.0,
            to_world=D.lookat([0, 1, -2.5], [0, 1, 0], [0, 1, 0]),
            aperture_radius=0.3,
            focus_distance=1.0,  # focus in front of the back wall
        )

    imgs = {}
    for kind in ("pinhole", "thinlens"):
        scene = scenes.cornell_box(width=24, height=24, spp=16)
        scene.camera = cam(kind)
        imgs[kind] = _render(scene, spp=16)
    # high-frequency content (gradient magnitude) must drop with the lens
    def sharpness(im):
        g = np.abs(np.diff(im, axis=0)).mean() + np.abs(np.diff(im, axis=1)).mean()
        return g

    assert sharpness(imgs["thinlens"]) < sharpness(imgs["pinhole"])


def test_splat_grid_band_matches_full():
    """Chunked row-band splat == whole-grid splat, bit-for-bit (the bench
    and chunked render paths accumulate bands; scatter splat was ~1s per
    518k-lane chunk before)."""
    import jax.numpy as jnp
    import numpy as np

    from kazen_tpu.film import film as film_mod
    from kazen_tpu.scene import description as D
    from kazen_tpu.scene.compiler import compile_scene

    import scenes

    sc = scenes.cornell_box(width=16, height=12)
    _, static = compile_scene(sc)
    h, w = static.height, static.width
    rng = np.random.default_rng(0)
    jitter = jnp.asarray(rng.random((h * w, 2), dtype=np.float32))
    value = jnp.asarray(rng.random((h * w, 3), dtype=np.float32))

    full = film_mod.splat_grid(
        static, film_mod.make_film(static), jitter, value
    )

    film = film_mod.make_film(static)
    rows_per = 4
    for row0 in range(0, h, rows_per):
        s = slice(row0 * w, (row0 + rows_per) * w)
        band = film_mod.splat_grid_band(static, jitter[s], value[s])
        film = film_mod.accumulate_band(static, film, band, row0)
    np.testing.assert_allclose(
        np.asarray(film), np.asarray(full), rtol=1e-6, atol=1e-6
    )
