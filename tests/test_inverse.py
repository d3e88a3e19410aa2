"""Inverse rendering: recover scene parameters from a target image."""
import numpy as np
import jax.numpy as jnp

import scenes
from kazen_tpu.scene import description as D
from kazen_tpu.scene.compiler import compile_scene
from kazen_tpu.integrate.render import render
from kazen_tpu.diff.inverse import optimize, get_params, apply_params


def test_recover_albedo():
    """Recover the back wall's diffuse albedo from a rendered target."""
    scene = scenes.cornell_box(width=16, height=16, spp=8, max_depth=3)
    arrays, static = compile_scene(scene, use_bvh=False)
    true_albedo = jnp.asarray([0.2, 0.6, 0.8])
    # back wall is mesh 2 -> material 2
    mats_true = arrays.materials._replace(
        base_color=arrays.materials.base_color.at[2].set(true_albedo)
    )
    target = render(arrays._replace(materials=mats_true), static, spp=8)

    # start from the wrong albedo and optimize
    res = optimize(
        arrays,
        static,
        target,
        param_keys=("materials",),
        steps=120,
        learning_rate=0.05,
        spp_per_step=2,
    )
    got = np.asarray(res.params["materials"]["base_color"][2])
    # the loss floor is the MC noise between the per-step spp and the
    # target's spp; parameter recovery is the real criterion
    assert res.losses[-1] < res.losses[0] * 0.35, res.losses[[0, -1]]
    np.testing.assert_allclose(got, np.asarray(true_albedo), atol=0.08)


def test_recover_light_intensity():
    scene = scenes.cornell_box(width=12, height=12, spp=4, max_depth=3)
    arrays, static = compile_scene(scene, use_bvh=False)
    target = render(
        arrays._replace(light_radiance=arrays.light_radiance * 0.5),
        static,
        spp=4,
    )
    res = optimize(
        arrays,
        static,
        target,
        param_keys=("light_radiance",),
        steps=80,
        learning_rate=0.4,
        spp_per_step=2,
        clip_to_unit=False,
    )
    got = np.asarray(res.params["light_radiance"])
    want = np.asarray(arrays.light_radiance) * 0.5
    np.testing.assert_allclose(got, want, rtol=0.12)


def test_recover_background_color():
    """Recover a constant env radiance through escape rays (config-5 style
    env recovery)."""
    import kazen_tpu.scene.description as D

    scene = scenes.cornell_box(
        width=12, height=12, spp=4, max_depth=3,
        background=D.Background(texture=D.ConstantTexture((0.8, 0.4, 0.1))),
    )
    arrays, static = compile_scene(scene, use_bvh=False)
    target = render(arrays, static, spp=4)
    start = arrays._replace(bg_color=jnp.asarray([0.3, 0.3, 0.3]))
    res = optimize(
        start,
        static,
        target,
        param_keys=("bg_color",),
        steps=80,
        learning_rate=0.1,
        # render each step with the target's exact sample indices: the MC
        # noise is then common to both sides and the L2 minimum sits at the
        # true parameter (single-sample steps converge to a biased
        # E[A]^2/(E[A^2]) multiple of it)
        spp_per_step=4,
        clip_to_unit=False,
    )
    got = np.asarray(res.params["bg_color"])
    np.testing.assert_allclose(got, [0.8, 0.4, 0.1], atol=0.05)


def _with_bvh(scene):
    """Compile with a BVH: traces then go through the BVH walk and the
    ordered wavefront's trace rows, and gradients flow through
    prepare_from_rows' closed-form recompute -- the structure the GPU
    path runs."""
    arrays, static = compile_scene(scene, use_bvh=True)
    assert arrays.bvh is not None
    return arrays, static


def test_recover_texture_map_through_trace_path():
    """Recover an image texture (texel pool) from a target rendered with
    the true texels -- through the BVH trace-row forward path. The checker pattern makes per-texel gradients heterogeneous,
    so this exercises real spatial texture recovery, not a scalar."""
    rng = np.random.default_rng(7)
    true_tex = (0.25 + 0.6 * rng.random((8, 8, 3))).astype(np.float32)
    scene = scenes.cornell_box(
        width=24, height=24, spp=4, max_depth=2,
        wall_bsdf=D.Lambertian(albedo=D.ImageTexture(
            data=true_tex, colorspace="linear"
        )),
    )
    arrays, static = _with_bvh(scene)
    target = render(arrays, static, spp=4)

    # start from flat gray texels
    gray = arrays.textures._replace(
        texels=jnp.full_like(arrays.textures.texels, 0.5)
    )
    start = arrays._replace(textures=gray)
    res = optimize(
        start,
        static,
        target,
        param_keys=("texels",),
        steps=100,
        learning_rate=0.08,
        spp_per_step=4,
    )
    assert res.losses[-1] < res.losses[0] * 0.2, res.losses[[0, -1]]
    err0 = float(jnp.mean(jnp.abs(gray.texels - arrays.textures.texels)))
    err1 = float(
        jnp.mean(jnp.abs(res.params["texels"] - arrays.textures.texels))
    )
    # mean texel error at least halves (mip tails/borders keep it nonzero)
    assert err1 < 0.5 * err0, (err0, err1)


def test_recover_env_tint_through_trace_path():
    """Recover the environment tint through escape rays on the BVH
    trace-row forward path."""
    scene = scenes.cornell_box(
        width=12, height=12, spp=4, max_depth=3,
        background=D.Background(texture=D.ConstantTexture((0.7, 0.3, 0.15))),
    )
    arrays, static = _with_bvh(scene)
    target = render(arrays, static, spp=4)
    start = arrays._replace(bg_color=jnp.asarray([0.4, 0.4, 0.4]))
    res = optimize(
        start,
        static,
        target,
        param_keys=("bg_color",),
        steps=80,
        learning_rate=0.1,
        spp_per_step=4,
        clip_to_unit=False,
    )
    got = np.asarray(res.params["bg_color"])
    np.testing.assert_allclose(got, [0.7, 0.3, 0.15], atol=0.05)
