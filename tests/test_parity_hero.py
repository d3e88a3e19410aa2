"""Image parity on the reference's OWN hero content (VERDICT r3 #3).

The toy-Cornell parity suite (test_parity.py) never exercised the scene
class that matters: 36k faces, 3 area lights, kiss everywhere
(scene/2022_q1/parameters/default_m0_r0.5.xml). These tests render the
real XML at reduced resolution through
  (a) the scalar oracle transliteration (tests/oracle_renderer.py),
  (b) the wavefront with the XLA BVH walk,
  (c) the wavefront with the GPU BVH walk kernel (interpret mode here)
and assert pairwise bad-pixel rates, test_parity._compare style.
"""
from _isolate import subprocess_isolated
import os

import numpy as np
import pytest

HERO_XML = "/root/reference/scene/2022_q1/parameters/default_m0_r0.5.xml"

pytestmark = pytest.mark.skipif(
    not os.path.exists(HERO_XML), reason="reference scene tree not present"
)


def _hero(width, height):
    from kazen_tpu.scene import xml_io
    from kazen_tpu.scene.compiler import compile_scene

    desc = xml_io.load_xml(HERO_XML)
    desc.camera.width = width
    desc.camera.height = height
    return compile_scene(desc)


def _render_both(arrays, static, monkeypatch, spp=2):
    """{False: XLA-walk image, True: kernel-walk image}."""
    import functools

    import jax

    from kazen_tpu.accel import backend
    from kazen_tpu.accel.bvh_kernel import intersect_bvh_kernel
    from kazen_tpu.integrate.render import render

    imgs = {False: np.asarray(render(arrays, static, spp=spp))}
    walk = functools.partial(intersect_bvh_kernel, interpret=True)
    monkeypatch.setattr(backend, "bvh_walk", lambda platform=None: walk)
    jax.clear_caches()
    imgs[True] = np.asarray(render(arrays, static, spp=spp))
    return imgs


def _bad_frac(a, b, atol):
    diff = np.abs(a - b)
    rel = diff / np.maximum(np.abs(b), 0.05)
    return (rel > atol).mean(), rel.max()


@subprocess_isolated
def test_hero_kernel_walk_vs_xla_walk(monkeypatch):
    """(b) vs (c) at 96x54/2spp: the GPU walk kernel against the plain
    XLA BVH walk on the real content."""
    arrays, static = _hero(96, 54)
    imgs = _render_both(arrays, static, monkeypatch)
    assert np.isfinite(imgs[True]).all()
    assert imgs[True].mean() > 0.05
    bad, worst = _bad_frac(imgs[True], imgs[False], atol=2e-3)
    assert bad <= 0.002, f"{bad:.4%} pixels differ (max rel {worst:.3g})"
    np.testing.assert_allclose(
        imgs[True].mean(), imgs[False].mean(), rtol=1e-3
    )


@pytest.mark.slow
@subprocess_isolated
def test_hero_oracle_parity():
    """(a) vs (b) at 16x9/2spp: the scalar reference transliteration
    against the wavefront on the real content, equal (sampler, spp,
    seed). (The scalar oracle pays ~36k brute face tests per ray and
    python-level per-sample machinery -- ~1.5s/sample on this scene --
    so the oracle side is capped at 288 samples.)"""
    from oracle_renderer import OracleRenderer

    from kazen_tpu.integrate.render import render

    arrays, static = _hero(16, 9)
    got = np.asarray(render(arrays, static, spp=2))
    want = OracleRenderer(arrays, static).render(spp=2)
    assert want.mean() > 0.05
    bad, worst = _bad_frac(got, want, atol=5e-3)
    assert bad <= 0.01, f"{bad:.4%} pixels differ (max rel {worst:.3g})"
    np.testing.assert_allclose(got.mean(), want.mean(), rtol=1e-3)


WARMSTUDIO_XML = "/root/reference/scene/2022_q1/WarmStudio/WarmStudio.xml"


@subprocess_isolated
def test_warmstudio_end_to_end_parity(monkeypatch):
    """The reference's other showcase scene (WarmStudio.xml:1-56): three
    OBJ meshes (hand-rolled OBJ loader path), kiss + diffuse, an area
    light ARRAY mesh, mitchell filter -- the multi-mesh/OBJ/mitchell
    combination the parameter sweeps never exercise (VERDICT r4 #7).
    Renders the real XML at reduced resolution through the XLA BVH walk
    and the GPU walk kernel (interpret mode) and asserts the images
    match."""
    from kazen_tpu.scene import xml_io
    from kazen_tpu.scene.compiler import compile_scene

    desc = xml_io.load_xml(WARMSTUDIO_XML)
    desc.camera.width = 96
    desc.camera.height = 54
    assert desc.rfilter.kind == "mitchell"
    arrays, static = compile_scene(desc)
    assert arrays.F.shape[0] > 100  # real OBJ geometry loaded
    imgs = _render_both(arrays, static, monkeypatch)
    assert np.isfinite(imgs[True]).all()
    assert imgs[True].mean() > 0.01  # light array illuminates the set
    bad, worst = _bad_frac(imgs[True], imgs[False], atol=2e-3)
    assert bad <= 0.002, f"{bad:.4%} pixels differ (max rel {worst:.3g})"
    np.testing.assert_allclose(
        imgs[True].mean(), imgs[False].mean(), rtol=1e-3
    )
