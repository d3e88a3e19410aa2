"""XML import, image IO round-trips, checkpoint/resume, CLI."""
import os
import numpy as np
import pytest

import scenes
from kazen_tpu.film import io as img_io
from kazen_tpu.scene.compiler import compile_scene
from kazen_tpu.integrate.render import render


def test_exr_roundtrip(tmp_path):
    img = np.random.default_rng(0).random((7, 13, 3)).astype(np.float32)
    p = str(tmp_path / "t.exr")
    img_io.save_exr(p, img)
    back = img_io.load_exr(p)
    np.testing.assert_array_equal(img, back)


def test_exr_zip_roundtrip(tmp_path):
    """ZIP-compressed EXR (zlib + ImfZip predictor over 16-line chunks):
    the reference ingests these via OIIO (bitmap.cpp:7-21)."""
    img = (np.random.default_rng(1).random((37, 19, 3)) * 5).astype(
        np.float32
    )
    p = str(tmp_path / "t_zip.exr")
    img_io.save_exr(p, img, compression="zip")
    assert os.path.getsize(p) < 37 * 19 * 3 * 4 + 400  # actually compressed
    np.testing.assert_array_equal(img, img_io.load_exr(p))


def test_png_write(tmp_path):
    img = np.random.default_rng(0).random((8, 8, 3)).astype(np.float32)
    p = str(tmp_path / "t.png")
    img_io.save_png(p, img)
    assert img_io.load_png(p).shape == (8, 8, 3)


def test_png_roundtrip(tmp_path):
    """save_png writes the sRGB-tonemapped 8-bit pixels, and load_png
    (zlib + struct, no imaging library) reads exactly those back."""
    from kazen_tpu.film.film import to_srgb8

    img = np.random.default_rng(3).random((5, 11, 3)).astype(np.float32) * 1.2
    p = str(tmp_path / "t.png")
    img_io.save_png(p, img)
    np.testing.assert_array_equal(img_io.load_png(p), to_srgb8(img))


def test_checkpoint_resume_identical(tmp_path):
    from kazen_tpu.film.checkpoint import render_resumable

    scene = scenes.cornell_box(width=12, height=12, spp=4)
    arrays, static = compile_scene(scene)
    direct = np.asarray(render(arrays, static, spp=4))
    ck = str(tmp_path / "ck.npz")
    # first run: only 2 of 4 samples (checkpoint_every=2 saves at s=2)
    render_resumable(
        arrays, static, spp=2, checkpoint_path=ck, checkpoint_every=2
    )
    # resume to full 4
    resumed = np.asarray(
        render_resumable(
            arrays, static, spp=4, checkpoint_path=ck, checkpoint_every=2
        )
    )
    np.testing.assert_allclose(direct, resumed, atol=1e-6)


def test_xml_import(tmp_path):
    # build a tiny OBJ + XML pair and render it
    obj = tmp_path / "quad.obj"
    obj.write_text(
        "v -1 0 -1\nv 1 0 -1\nv 1 0 1\nv -1 0 1\n"
        "vn 0 1 0\nvn 0 1 0\nvn 0 1 0\nvn 0 1 0\n"
        "f 1//1 2//2 3//3 4//4\n"
    )
    light_obj = tmp_path / "light.obj"
    light_obj.write_text(
        "v -0.3 1.9 -0.3\nv 0.3 1.9 -0.3\nv 0.3 1.9 0.3\nv -0.3 1.9 0.3\n"
        "f 1 2 3 4\n"
    )
    xml = tmp_path / "scene.xml"
    xml.write_text(
        """<?xml version="1.0"?>
<scene>
  <integrator type="path_mis"><integer name="maxDepth" value="3"/></integrator>
  <sampler type="stratified"><integer name="sampleCount" value="4"/></sampler>
  <camera type="perspective">
    <integer name="width" value="12"/><integer name="height" value="12"/>
    <float name="fov" value="60"/>
    <transform name="toWorld">
      <lookat origin="0, 1, -3" target="0, 0.5, 0" up="0, 1, 0"/>
    </transform>
    <rfilter type="gaussian"><float name="radius" value="2.0"/></rfilter>
  </camera>
  <mesh type="obj">
    <string name="filename" value="quad.obj"/>
    <bsdf type="kazenstandard">
      <texture type="constanttexture" id="baseColor">
        <color name="color" value="0.6 0.3 0.2"/>
      </texture>
    </bsdf>
  </mesh>
  <mesh type="obj">
    <string name="filename" value="light.obj"/>
    <light type="area">
      <color name="color" value="1 1 1"/><float name="intensity" value="10"/>
    </light>
  </mesh>
</scene>
"""
    )
    from kazen_tpu.scene.xml_io import load_xml

    scene = load_xml(str(xml))
    assert scene.camera.width == 12
    assert scene.sampler.kind == "stratified"
    assert scene.rfilter.kind == "gaussian"
    arrays, static = compile_scene(scene)
    assert static.num_lights == 1
    img = np.asarray(render(arrays, static))
    assert np.isfinite(img).all()
    assert img.mean() > 0.001


def test_cli(tmp_path):
    # reuse the xml scene from above via the CLI entry point
    test_xml_import(tmp_path)
    out = str(tmp_path / "out.png")
    from kazen_tpu.cli.main import main

    main([str(tmp_path / "scene.xml"), "-o", out, "--spp", "2"])
    assert os.path.exists(out)


def test_splat_grid_matches_scatter():
    import jax.numpy as jnp
    from kazen_tpu.film import film as film_mod
    from kazen_tpu.scene.compiler import compile_scene as _cs

    for kind in ("box", "gaussian", "tent", "mitchell"):
        scene = scenes.cornell_box(width=9, height=7, spp=1)
        scene.rfilter.kind = kind
        _, static = _cs(scene)
        r = np.random.default_rng(4)
        n = 63
        jitter = jnp.asarray(r.random((n, 2), dtype=np.float32))
        value = jnp.asarray(r.random((n, 3), dtype=np.float32))
        ys, xs = np.meshgrid(np.arange(7), np.arange(9), indexing="ij")
        px = jnp.asarray(xs.ravel(), jnp.uint32)
        py = jnp.asarray(ys.ravel(), jnp.uint32)
        film0 = film_mod.make_film(static)
        a = film_mod.splat(static, film0, px, py, jitter, value)
        b = film_mod.splat_grid(static, film0, jitter, value)
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5), kind


@pytest.mark.parametrize("kind", ["box", "gaussian"])
@pytest.mark.parametrize("jitter", [0.0, 2.0**-24, 1.0 - 2.0**-24])
def test_splat_keeps_edge_samples_in_their_pixel(kind, jitter):
    """A sample at x >= 1024 with jitter next to 0 or 1: px + jitter would
    round to a pixel edge in f32. The lane-layout splat must still put
    it where the grid splat does."""
    import jax.numpy as jnp
    from kazen_tpu.film import film as film_mod
    from kazen_tpu.scene.compiler import compile_scene as _cs

    w, h = 1600, 3
    scene = scenes.cornell_box(width=w, height=h, spp=1)
    scene.rfilter.kind = kind
    _, static = _cs(scene, use_bvh=False)
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    r = np.random.default_rng(7)
    jit_ = r.random((h * w, 2), dtype=np.float32)
    jit_[:, 0] = np.where(xs.ravel() >= 1024, np.float32(jitter), jit_[:, 0])
    value = jnp.asarray(r.random((h * w, 3), dtype=np.float32))
    film0 = film_mod.make_film(static)
    a = film_mod.splat(
        static, film0, jnp.asarray(xs.ravel(), jnp.uint32),
        jnp.asarray(ys.ravel(), jnp.uint32), jnp.asarray(jit_), value,
    )
    b = film_mod.splat_grid(static, film0, jnp.asarray(jit_), value)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6, atol=1e-6)


def test_texture_graph_nodes():
    import jax.numpy as jnp
    from kazen_tpu.scene import description as D
    from kazen_tpu.scene.compiler import compile_scene as _cs
    from kazen_tpu.shade.textures import eval_texture

    checker = np.zeros((4, 4, 3), np.float32)
    checker[::2, ::2] = 1.0
    checker[1::2, 1::2] = 1.0
    img = D.ImageTexture(data=checker, colorspace="linear")
    blend = D.Blend(
        mask=D.ConstantTexture((0.25, 0, 0)),
        input1=D.ConstantTexture((1.0, 0.0, 0.0)),
        input2=D.ConstantTexture((0.0, 1.0, 0.0)),
        mode="mix",
    )
    ramp = D.ColorRamp(input=img, min=0.2, max=0.8)
    scene = scenes.cornell_box(width=8, height=8, spp=1)
    scene.meshes[0].bsdf = D.Lambertian(albedo=blend)
    scene.meshes[1].bsdf = D.Lambertian(albedo=ramp)
    arrays, static = _cs(scene, use_bvh=False)

    mats = arrays.materials
    uv = jnp.asarray(np.random.default_rng(0).random((64, 2), np.float32))
    # blend mix: (1-0.25)*[1,0,0] + 0.25*[0,1,0] = [0.75, 0.25, 0]
    bid = jnp.full(64, int(mats.tex_base[0]), jnp.int32)
    got = np.asarray(
        eval_texture(static, arrays.textures, bid, uv, jnp.zeros((64, 3)))
    )
    np.testing.assert_allclose(got, [[0.75, 0.25, 0.0]] * 64, atol=1e-6)
    # colorramp over checker: values in {0.2, 0.8}
    rid = jnp.full(64, int(mats.tex_base[1]), jnp.int32)
    got = np.asarray(
        eval_texture(static, arrays.textures, rid, uv, jnp.zeros((64, 3)))
    )
    assert ((got >= 0.2 - 1e-5) & (got <= 0.8 + 1e-5)).all()
    # renders fine
    from kazen_tpu.integrate.render import render

    img_out = np.asarray(render(arrays, static, spp=1))
    assert np.isfinite(img_out).all()


def test_reference_scene_renders():
    """Import + render an actual nano-kazen scene (kiss parameter sweep,
    scene/2022_q1/parameters) through the full pipeline."""
    import os

    path = "/root/reference/scene/2022_q1/parameters/default_m0_r0.5.xml"
    if not os.path.exists(path):
        return
    from kazen_tpu.scene.xml_io import load_xml
    from kazen_tpu.integrate.render import render

    scene = load_xml(path)
    assert len(scene.meshes) == 5
    scene.camera.width, scene.camera.height = 96, 54
    arrays, static = compile_scene(scene)
    assert int(arrays.F.shape[0]) > 30000
    assert static.num_lights == 3
    img = np.asarray(render(arrays, static, spp=2))
    assert np.isfinite(img).all()
    assert img.mean() > 0.1


def test_mip_textures_minified_checker():
    """Filtered minification (texture.cpp:46-64 analog): a heavily
    minified checker must converge to mid-gray with mip_textures on, while
    level-0 bilinear keeps near-binary texel noise at the same spp."""
    import jax.numpy as jnp
    from kazen_tpu.scene import description as D
    from kazen_tpu.shade.textures import eval_texture

    checker = np.zeros((64, 64, 3), np.float32)
    checker[::2, ::2] = 1.0
    checker[1::2, 1::2] = 1.0
    tex = D.ImageTexture(data=checker, colorspace="linear", scale=40.0)

    def floor_scene(mips):
        v = np.array(
            [[-50, 0, -50], [50, 0, -50], [50, 0, 50], [-50, 0, 50]],
            np.float32,
        )
        f = np.array([[0, 2, 1], [0, 3, 2]], np.int32)
        n = np.tile([0, 1, 0], (4, 1)).astype(np.float32)
        uvs = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
        lv = np.array(
            [[-1, 8, -1], [1, 8, -1], [1, 8, 1], [-1, 8, 1]], np.float32
        )
        lf = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
        return D.Scene(
            meshes=[
                D.Mesh(vertices=v, faces=f, normals=n, uvs=uvs,
                       bsdf=D.Lambertian(albedo=tex)),
                D.Mesh(vertices=lv, faces=lf,
                       normals=np.tile([0, -1, 0], (4, 1)).astype(np.float32),
                       bsdf=D.Diffuse((0, 0, 0)),
                       light=D.AreaLight(intensity=40.0)),
            ],
            camera=D.PerspectiveCamera(
                width=48, height=32, fov=50.0,
                to_world=D.lookat([0, 0.4, -6], [0, 0.2, 6], [0, 1, 0]),
            ),
            sampler=D.Sampler(kind="independent", sample_count=2),
            integrator=D.PathMis(max_depth=2),
            rfilter=D.RFilter(kind="box"),
            mip_textures=mips,
        )

    # mip chain built correctly: 64x64 checker fully averages to 0.5 by L1
    arrays, static = compile_scene(floor_scene(True))
    pool = arrays.textures
    assert int(pool.n_levels.max()) == 7  # 64 -> 1
    off1 = int(np.asarray(pool.mip_offset)[int(np.argmax(np.asarray(pool.n_levels))), 1])
    lvl1 = np.asarray(pool.texels)[off1:off1 + 32 * 32]
    np.testing.assert_allclose(lvl1, 0.5, atol=1e-6)

    from kazen_tpu.integrate.render import render

    img_mip = np.asarray(render(arrays, static, spp=2))
    arrays0, static0 = compile_scene(floor_scene(False))
    img_raw = np.asarray(render(arrays0, static0, spp=2))
    # mid-distance rows: within-row variance (lighting is ~constant along
    # a row, so this isolates texel noise) collapses under mips while
    # level-0 bilinear stays high-variance at equal spp
    noise_mip = img_mip[20:30, :, 0].std(axis=1).mean()
    noise_raw = img_raw[20:30, :, 0].std(axis=1).mean()
    assert noise_mip < 0.5 * noise_raw, (noise_mip, noise_raw)
