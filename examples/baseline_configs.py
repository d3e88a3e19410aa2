#!/usr/bin/env python
"""BASELINE.json config scenes, runnable end-to-end.

  1. diffuse sphere + quad light, 64x64 @ 16 spp, independent  (CPU-ok)
  2. Cornell, diffuse+GGX, NEE+MIS, 256x256 @ 128 spp, stratified
  3. kiss full stack (clearcoat+sheen, normal map, textures, thin lens) 512^2;
     lookdev_scene() is the same frame at 1080p with 36,876 faces
  4. con-2: pmj02bn + terminator + regularization + env light, 1080p
  5. inverse rendering: recover roughness/albedo from a target

Usage: python examples/baseline_configs.py <1|2|3|4|5> [--spp N] [--out f.png]
"""
import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(
    0,
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests"),
)


def make_sphere(center, radius, n_theta=24, n_phi=48):
    from kazen_tpu.scene import description as D

    th = np.linspace(0, np.pi, n_theta)
    ph = np.linspace(0, 2 * np.pi, n_phi, endpoint=False)
    tt, pp = np.meshgrid(th, ph, indexing="ij")
    x = np.sin(tt) * np.cos(pp)
    y = np.cos(tt)
    z = np.sin(tt) * np.sin(pp)
    pts = np.stack([x, y, z], -1).reshape(-1, 3)
    verts = (center + radius * pts).astype(np.float32)
    normals = pts.astype(np.float32)
    faces = []
    for i in range(n_theta - 1):
        for j in range(n_phi):
            a = i * n_phi + j
            b = i * n_phi + (j + 1) % n_phi
            c = (i + 1) * n_phi + j
            d = (i + 1) * n_phi + (j + 1) % n_phi
            faces.append([a, b, c])
            faces.append([b, d, c])
    uvs = np.stack([pp / (2 * np.pi), 1.0 - tt / np.pi], -1).reshape(-1, 2)
    return D.Mesh(
        vertices=verts,
        faces=np.asarray(faces, np.int32),
        normals=normals,
        uvs=uvs.astype(np.float32),
    )


def lookdev_scene(
    width=1920, height=1080, spp=4, max_depth=5, seed=0,
    n_theta=97, n_phi=96,
):
    """Config 3, the look-dev frame: two kiss spheres in a Cornell box,
    one with a seeded image texture (clearcoat + sheen), one under a
    seeded normal map, seen through a thin-lens camera. The default
    tessellation gives 2 x 96 x 96 x 2 + 12 = 36,876 faces, the size of
    the reference's 36,378-face hero frame."""
    import scenes
    from kazen_tpu.scene import description as D

    rng = np.random.default_rng(seed)
    checker = np.full((64, 64, 3), 0.15, np.float32)
    checker[::8, :] = 1.0
    checker[:, ::8] = 1.0
    checker *= (0.6 + 0.4 * rng.random((8, 8, 3))).repeat(8, 0).repeat(8, 1)
    bump = np.full((32, 32, 3), (0.5, 0.5, 1.0), np.float32)
    bump[:, :, :2] += 0.2 * (rng.random((32, 32, 2)) - 0.5)
    sphere = make_sphere([-0.4, 0.6, 0.2], 0.6, n_theta, n_phi)
    sphere.bsdf = D.KazenStandard(
        base_color=D.ImageTexture(data=checker, colorspace="linear"),
        roughness=D.ConstantTexture((0.25,) * 3),
        metallic=D.ConstantTexture((0.4,) * 3),
        clearcoat=0.8,
        sheen=0.5,
    )
    sphere2 = make_sphere([0.6, 0.4, -0.2], 0.4, n_theta, n_phi)
    sphere2.bsdf = D.NormalMap(
        nested=D.KazenStandard(
            base_color=D.ConstantTexture((0.8, 0.3, 0.2)),
            roughness=D.ConstantTexture((0.15,) * 3),
        ),
        normals=D.ImageTexture(data=bump, colorspace="linear"),
    )
    sc = scenes.cornell_box(
        width=width, height=height, spp=spp, max_depth=max_depth,
        extra_meshes=[sphere, sphere2],
    )
    sc.camera = D.ThinlensCamera(
        width=width, height=height, fov=60.0,
        to_world=D.lookat([0, 1, -2.5], [0, 1, 0], [0, 1, 0]),
        aperture_radius=0.05, focus_distance=2.4,
    )
    return sc


def config_scene(n, spp=None):
    import scenes
    from kazen_tpu.scene import description as D

    if n == 1:
        sphere = make_sphere([0.0, 0.6, 0.0], 0.6, 12, 24)
        sphere.bsdf = D.Diffuse((0.65, 0.5, 0.4))
        sc = scenes.cornell_box(
            width=64, height=64, spp=spp or 16, extra_meshes=[sphere]
        )
        return sc
    if n == 2:
        sphere = make_sphere([0.4, 0.5, 0.3], 0.5)
        sphere.bsdf = D.GGX(albedo=D.ConstantTexture((0.9, 0.7, 0.3)), roughness=0.2)
        return scenes.cornell_box(
            width=256, height=256, spp=spp or 128, sampler="stratified",
            extra_meshes=[sphere],
        )
    if n == 3:
        return lookdev_scene(512, 512, spp=spp or 64, n_theta=24, n_phi=48)
    if n == 4:
        env = np.zeros((32, 64, 3), np.float32)
        env[:12] = (0.3, 0.5, 0.9)  # sky
        env[12:] = (0.15, 0.12, 0.1)
        sphere = make_sphere([0.0, 0.55, 0.0], 0.55)
        sphere.bsdf = D.KazenStandard(
            base_color=D.ConstantTexture((0.7, 0.6, 0.5)),
            roughness=D.ConstantTexture((0.1,) * 3),
            metallic=D.ConstantTexture((0.7,) * 3),
        )
        sc = scenes.cornell_box(
            width=1920, height=1080, spp=spp or 16, sampler="pmj02bn",
            extra_meshes=[sphere], regularization=True,
            background=D.Background(
                texture=D.ImageTexture(data=env, colorspace="linear"),
                intensity=1.0,
            ),
        )
        return sc
    raise SystemExit(f"config {n} handled elsewhere")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("config", type=int)
    ap.add_argument("--spp", type=int, default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--platform", default=None)
    args = ap.parse_args()

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)

    from kazen_tpu.scene.compiler import compile_scene
    from kazen_tpu.integrate.render import render
    from kazen_tpu.film import io as img_io
    from kazen_tpu.utils.metrics import RenderMetrics

    if args.config == 5:
        # inverse rendering demo on config-2 geometry at reduced res
        import jax.numpy as jnp
        from kazen_tpu.diff.inverse import optimize

        sc = config_scene(2, spp=8)
        sc.camera.width = sc.camera.height = 64
        arrays, static = compile_scene(sc)
        true_rough = 0.35
        mats = arrays.materials._replace(
            roughness=arrays.materials.roughness.at[-1].set(true_rough)
        )
        target = render(arrays._replace(materials=mats), static, spp=8)
        res = optimize(
            arrays, static, target, steps=80, spp_per_step=2,
            param_keys=("materials",),
        )
        got = float(res.params["materials"]["roughness"][-1])
        print(f"recovered roughness {got:.3f} (true {true_rough})")
        return

    sc = config_scene(args.config, args.spp)
    t0 = time.time()
    arrays, static = compile_scene(sc)
    print(f"compiled {int(arrays.F.shape[0])} faces in {time.time()-t0:.1f}s")
    metrics = RenderMetrics()
    t0 = time.time()
    img = np.asarray(render(arrays, static, spp=args.spp, verbose=True, metrics=metrics))
    print(f"rendered in {time.time()-t0:.1f}s: {metrics.summary()}")
    out = args.out or f"config{args.config}.png"
    img_io.save_png(out, img)
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
