"""Staged (host-narrowed) wavefront driver == scan driver.

The staged driver (integrate/staged.py) runs later bounces on a narrowed
lane prefix chosen from the host-read alive count; lanes outside the
prefix are provably inert, so the image must equal the lax.scan
driver's at equal (sampler, spp, seed) to float-ulp level (the two
drivers compile the same bounce ops in different programs, so XLA may
reassociate/fuse differently; semantics are identical). Covers:
  - a BVH scene (narrowing active, several menu widths hit)
  - the hero XML (when the reference tree is present)
  - a brute-force scene (_ordering_useful False -> full-width fallback)
"""
import os

import numpy as np
import pytest

import scenes

HERO_XML = "/root/reference/scene/2022_q1/parameters/default_m0_r0.5.xml"


def _li_both(arrays, static, n_lanes=None):
    import jax.numpy as jnp

    from kazen_tpu.core import rng
    from kazen_tpu.integrate import camera as camera_mod
    from kazen_tpu.integrate.path_mis import li_wavefront
    from kazen_tpu.integrate import path_mis
    from kazen_tpu.integrate.render import sampler_spec
    from kazen_tpu.integrate.staged import StagedWavefront
    from kazen_tpu.samplers import streams

    spec = sampler_spec(static)
    h, w = static.height, static.width
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    px = jnp.asarray(xs.reshape(-1).astype(np.uint32))
    py = jnp.asarray(ys.reshape(-1).astype(np.uint32))
    a, c = rng.advance_constants(0)
    jump = (
        (jnp.uint32(a >> 32), jnp.uint32(a & 0xFFFFFFFF)),
        (jnp.uint32(c >> 32), jnp.uint32(c & 0xFFFFFFFF)),
    )
    stream = streams.init_stream_jump(spec, px, py, jnp.uint32(0), jump)
    stream, jitter = streams.next_pixel_2d(spec, stream)
    ps = jnp.stack([px, py], -1).astype(jnp.float32) + jitter
    stream, ap = streams.next_2d(spec, stream)
    rays = camera_mod.sample_ray(arrays, static, ps, ap)
    _, li_scan, n_scan = li_wavefront(arrays, static, spec, stream, rays)
    sw = StagedWavefront(
        static, h * w,
        lambda scene, stream, rays: (
            path_mis.wavefront_init(scene, static, spec, stream, rays),
        ),
        lambda scene, st: path_mis.wavefront_finish(scene, static, st),
    )
    (_, li_stag, n_stag), record = sw.run(arrays, spec, stream, rays)
    return (
        np.asarray(li_scan),
        np.asarray(li_stag),
        float(n_scan),
        float(n_stag),
        record.widths,
    )


def test_staged_matches_scan_multicluster():
    # a BVH scene -> narrowing is active and at least one bounce runs at a
    # sub-full menu width
    from kazen_tpu.scene import description as D

    scene = scenes.cornell_box(
        width=48,
        height=48,
        max_depth=5,
        extra_meshes=(
            scenes.sphere_mesh(
                np.array([0.0, 0.8, 0.3]),
                0.45,
                nu=24,
                nv=24,
                bsdf=D.Diffuse((0.5, 0.5, 0.5)),
            ),
        ),
    )
    from kazen_tpu.scene.compiler import compile_scene

    arrays, static = compile_scene(scene)
    assert arrays.bvh is not None
    li_a, li_b, n_a, n_b, widths = _li_both(arrays, static)
    np.testing.assert_allclose(li_a, li_b, rtol=2e-6, atol=1e-6)
    assert n_a == n_b
    assert widths[0] == 48 * 48
    assert min(widths) < widths[0], widths  # narrowing happened


@pytest.mark.skipif(
    not os.path.exists(HERO_XML), reason="reference scene tree not present"
)
def test_staged_matches_scan_hero():
    from kazen_tpu.scene import xml_io
    from kazen_tpu.scene.compiler import compile_scene

    desc = xml_io.load_xml(HERO_XML)
    desc.camera.width = 96
    desc.camera.height = 54
    arrays, static = compile_scene(desc)
    li_a, li_b, n_a, n_b, _ = _li_both(arrays, static)
    np.testing.assert_allclose(li_a, li_b, rtol=2e-6, atol=1e-6)
    assert n_a == n_b


def test_staged_matches_scan_single_cluster_fallback():
    # 12-tri box: brute-force trace, _ordering_useful False -> the staged
    # driver must fall back to full width and still match exactly
    scene = scenes.cornell_box(width=32, height=32, max_depth=4)
    from kazen_tpu.scene.compiler import compile_scene

    arrays, static = compile_scene(scene)
    assert arrays.bvh is None
    li_a, li_b, n_a, n_b, widths = _li_both(arrays, static)
    np.testing.assert_allclose(li_a, li_b, rtol=2e-6, atol=1e-6)
    assert n_a == n_b
    assert set(widths) == {32 * 32}  # no narrowing without the permute
