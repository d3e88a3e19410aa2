"""Distributed rendering on the 8-device virtual CPU mesh: sharded results
must equal single-device results exactly (counter-based streams make the
image placement-independent), and the sharded inverse step must match the
unsharded gradients."""
import numpy as np
import jax
import jax.numpy as jnp

import scenes
from _isolate import subprocess_isolated
from kazen_tpu.scene.compiler import compile_scene
from kazen_tpu.integrate.render import render
from kazen_tpu.dist.sharding import (
    inverse_train_step,
    make_mesh,
    render_distributed,
    render_sample_sharded,
)


def test_distributed_matches_single():
    assert len(jax.devices()) == 8
    scene = scenes.cornell_box(width=16, height=16, spp=2)
    arrays, static = compile_scene(scene)
    single = np.asarray(render(arrays, static, spp=2))
    mesh = make_mesh()
    dist = np.asarray(render_distributed(mesh, arrays, static, spp=2))
    np.testing.assert_allclose(single, dist, atol=1e-5)


def test_sample_sharded_matches_single(kernel_walk):
    """pixels x sample-batches lane axis over shard_map (SURVEY §2.8's
    sample-dimension sharding), with every trace through the GPU walk
    kernel (interpret mode): the per-bounce wavefront permute runs
    shard-local and the only collective is the film psum; the image must
    equal the serial render (counter-based streams are lane-placement
    independent)."""
    scene = scenes.cornell_box(width=16, height=16, spp=4)
    scene.meshes.append(
        scenes.sphere_mesh((0.3, 0.5, 0.3), 0.35, nu=10, nv=10)
    )
    arrays, static = compile_scene(scene)
    assert arrays.bvh is not None
    single = np.asarray(render(arrays, static, spp=4))
    mesh = make_mesh()
    for batches in (2, 4):
        dist = np.asarray(
            render_sample_sharded(
                mesh, arrays, static, spp=4, sample_batches=batches
            )
        )
        np.testing.assert_allclose(single, dist, atol=1e-5)


@subprocess_isolated
def test_sharded_inverse_step_grads_match():
    from jax.sharding import NamedSharding, PartitionSpec as P
    from kazen_tpu.integrate.render import sampler_spec
    from kazen_tpu.core import rng

    scene = scenes.cornell_box(width=8, height=8, spp=1, max_depth=2)
    arrays, static = compile_scene(scene)
    spec = sampler_spec(static)
    mesh = make_mesh()
    step = inverse_train_step(mesh, arrays, static, spec)

    h, w = static.height, static.width
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    px = xs.reshape(-1).astype(np.uint32)
    py = ys.reshape(-1).astype(np.uint32)
    lane = NamedSharding(mesh, P("devices"))
    px_d = jax.device_put(jnp.asarray(px), lane)
    py_d = jax.device_put(jnp.asarray(py), lane)
    target = jnp.zeros((h, w, 3))
    a, c = rng.advance_constants(0)
    jump = (
        (jnp.uint32(a >> 32), jnp.uint32(a & 0xFFFFFFFF)),
        (jnp.uint32(c >> 32), jnp.uint32(c & 0xFFFFFFFF)),
    )
    loss8, grads8 = step(arrays, target, px_d, py_d, jnp.uint32(0), jump)

    # single-device reference via a 1-device mesh
    mesh1 = make_mesh(jax.devices()[:1])
    step1 = inverse_train_step(mesh1, arrays, static, spec)
    lane1 = NamedSharding(mesh1, P("devices"))
    loss1, grads1 = step1(
        arrays,
        target,
        jax.device_put(jnp.asarray(px), lane1),
        jax.device_put(jnp.asarray(py), lane1),
        jnp.uint32(0),
        jump,
    )
    np.testing.assert_allclose(float(loss8), float(loss1), rtol=1e-5)
    for k in grads8:
        np.testing.assert_allclose(
            np.asarray(grads8[k]), np.asarray(grads1[k]), rtol=2e-4, atol=1e-6
        ), k
