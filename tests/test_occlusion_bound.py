"""Shadow-ray step-through on adversarial geometry: GPU walk == XLA walk.

The reference resolves a shadow ray by iteratively re-casting past
primary-invisible lights from ``hit.t + traceBias``
(the reference's integrator.cpp:259-278), so an occluder hidden
*within trace_bias behind* an invisible light's surface is stepped over
(the reference reports the path unoccluded). Both BVH walks -- the XLA
walk and the GPU kernel (run here in interpret mode) -- serve that
step-through as repeated nearest-hit traces, so they must agree on the
adversarial case too:

* eps > 2*trace_bias: the occluder is found; images match.
* eps < 2*trace_bias: the occluder is stepped over; images match, and
  differ from the eps > 2*trace_bias frame where the occluder is found.
* no occluder: images match.
"""
import functools

import jax
import numpy as np

from _isolate import subprocess_isolated

from kazen_tpu.accel import backend
from kazen_tpu.accel.bvh_kernel import intersect_bvh_kernel
from kazen_tpu.scene import description as D
from kazen_tpu.scene.compiler import compile_scene
from kazen_tpu.integrate.render import render

from scenes import make_mesh

TRACE_BIAS = 1e-3


def _scene(eps, with_occluder=True):
    diffuse = D.Diffuse(albedo=(0.7, 0.7, 0.7))
    meshes = [
        # floor at y=0, normal +y
        make_mesh([-2, 0, -2], [4, 0, 0], [0, 0, 4], bsdf=diffuse, flip=True),
        # main light at y=2, facing down. primary_visibility stays at
        # the reference default (False): a step-through recast's segment
        # ends EXACTLY on the sampled light surface (integrator.cpp:272:
        # maxt -= its.t while the origin advances by its.t + eps), so a
        # visible target light turns every stepped-through sample into an
        # FP-borderline self-occlusion -- an instability of the reference
        # algorithm itself, not the deviation under test here.
        make_mesh(
            [-0.5, 2.0, -0.5], [1, 0, 0], [0, 0, 1],
            light=D.AreaLight(intensity=10.0, primary_visibility=False),
        ),
        # invisible light at y=1, facing down (the step-through target)
        make_mesh(
            [-0.7, 1.0, -0.7], [1.4, 0, 0], [0, 0, 1.4],
            light=D.AreaLight(intensity=1e-4, primary_visibility=False),
        ),
    ]
    if with_occluder:
        # occluder eps ABOVE the invisible light (behind it along the
        # floor->main-light shadow ray)
        meshes.append(
            make_mesh(
                [-0.7, 1.0 + eps, -0.7], [1.4, 0, 0], [0, 0, 1.4],
                bsdf=diffuse,
            )
        )
    cam = D.PerspectiveCamera(
        width=24, height=24, fov=40.0,
        to_world=D.lookat([0.0, 0.6, 2.2], [0.0, 0.0, 0.0], [0, 1, 0]),
    )
    return D.Scene(
        meshes=meshes,
        camera=cam,
        sampler=D.Sampler(kind="independent", sample_count=1, seed=7),
        integrator=D.PathMis(max_depth=1, trace_bias=TRACE_BIAS),
    )


def _render(desc, monkeypatch, kernel: bool, spp=16):
    arrays, static = compile_scene(desc, use_bvh=True)
    with monkeypatch.context() as m:
        if kernel:
            walk = functools.partial(intersect_bvh_kernel, interpret=True)
            m.setattr(backend, "bvh_walk", lambda platform=None: walk)
        jax.clear_caches()
        return np.asarray(render(arrays, static, spp=spp))


@subprocess_isolated
def test_occluder_beyond_bias_agrees(monkeypatch):
    """eps = 4*bias: both walks find the occluder -> identical images.
    (The reference recast skips occluders up to eps = 2*bias: it restarts
    at t + bias with mint = bias, integrator.cpp:272; eps exactly 2*bias
    is an FP borderline.)"""
    desc = _scene(eps=4.0 * TRACE_BIAS)
    img_xla = _render(desc, monkeypatch, kernel=False)
    img_kernel = _render(desc, monkeypatch, kernel=True)
    np.testing.assert_allclose(img_kernel, img_xla, atol=2e-5)


@subprocess_isolated
def test_occluder_within_bias_deviation_bounded(monkeypatch):
    """eps = bias/2: both walks step over the occluder as the reference
    does, so they agree, and the frame is brighter than the one in which
    the occluder sits beyond the bias and is found."""
    img_xla = _render(_scene(eps=0.5 * TRACE_BIAS), monkeypatch, kernel=False)
    img_kernel = _render(_scene(eps=0.5 * TRACE_BIAS), monkeypatch, kernel=True)
    np.testing.assert_allclose(img_kernel, img_xla, atol=2e-5)
    img_found = _render(_scene(eps=4.0 * TRACE_BIAS), monkeypatch, kernel=True)
    stepped_over = img_kernel - img_found
    assert stepped_over.max() > 1e-3, "the occluder must be stepped over"


@subprocess_isolated
def test_no_adversarial_geometry_no_deviation(monkeypatch):
    """Without the occluder the two walks agree exactly (the invisible
    light itself never blocks)."""
    desc = _scene(eps=0.0, with_occluder=False)
    img_xla = _render(desc, monkeypatch, kernel=False)
    img_kernel = _render(desc, monkeypatch, kernel=True)
    np.testing.assert_allclose(img_kernel, img_xla, atol=2e-5)
