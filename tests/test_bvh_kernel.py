"""The GPU BVH walk (accel/bvh_kernel.py, Pallas/Triton) in interpret mode
against the XLA walk and the brute-force oracle, plus the plumbing around
it: padding, node packing, the gradient rule, the backend choice, the
compile-cache rule, and chip_smoke.py refusing to run without a GPU."""
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kazen_tpu.accel import backend
from kazen_tpu.accel import bvh as bvh_mod
from kazen_tpu.accel.bvh_kernel import BLOCK, intersect_bvh_kernel, walk_prims
from kazen_tpu.accel.intersect import Rays, intersect_brute

from scenes import sphere_mesh
from test_bvh import _FakeScene, random_rays, random_soup

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
kernel = functools.partial(intersect_bvh_kernel, interpret=True)


def _spheres():
    meshes = [
        sphere_mesh([0.0, 0.0, 0.0], 1.0, nu=16, nv=12),
        sphere_mesh([1.5, 0.5, -0.5], 0.6, nu=10, nv=8),
    ]
    offs = np.cumsum([0] + [len(m.vertices) for m in meshes])
    V = np.concatenate([m.vertices for m in meshes])
    F = np.concatenate([m.faces + o for m, o in zip(meshes, offs)])
    return V, F


def _rays(o, d, mint=1e-4, maxt=3.0e38):
    o = np.asarray(o, np.float32)
    d = np.asarray(d, np.float32)
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    n = len(o)
    return Rays(
        o=jnp.asarray(o), d=jnp.asarray(d),
        mint=jnp.full(n, mint, jnp.float32),
        maxt=jnp.asarray(np.broadcast_to(np.float32(maxt), (n,))),
    )


def _case(name):
    rng = np.random.default_rng(5)
    if name == "edge_rays":
        # rays through the edges and the vertex that the triangles of a
        # fan share (inside the fan's box: a ray parallel to a box face
        # and on it misses the slab test in both walks)
        V = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0], [0.5, 0.5, 0]],
                     np.float32)
        F = np.array([[0, 1, 4], [1, 2, 4], [2, 3, 4], [3, 0, 4]], np.int32)
        t = np.linspace(0.05, 0.95, 19, dtype=np.float32)
        pts = np.concatenate([
            np.stack([t, t, 0 * t], -1), np.stack([t, 1 - t, 0 * t], -1),
            V[4:],
        ])
        return V, F, _rays(pts + [0, 0, 1], np.tile([0, 0, -1], (len(pts), 1)))
    if name == "random_soup":
        V, F = random_soup(300, 9)
        return V, F, random_rays(256, 4)
    V, F = _spheres()
    n = {"spheres": 256, "ragged_lanes": 77}.get(name, 96)
    o = rng.uniform(-2, 2, (n, 3)) + [0, 0, -4]
    d = rng.uniform(-1.2, 1.6, (n, 3)) * [1, 1, 0] - o  # aim at the spheres
    if name == "miss_only":
        d = -d  # away from every sphere
    maxt = {"maxt_clipped": 3.6, "dead_lanes": -1.0}.get(name, 3.0e38)
    return V, F, _rays(o, d, maxt=maxt)


@pytest.mark.parametrize(
    "name",
    ["spheres", "random_soup", "miss_only", "ragged_lanes", "maxt_clipped",
     "dead_lanes", "edge_rays"],
)
def test_kernel_matches_xla_walk_and_brute(name):
    V, F, rays = _case(name)
    scene = _FakeScene(V, F, bvh_mod.build_bvh(V, F))
    got = kernel(scene, rays)
    walk = bvh_mod.intersect_bvh(scene, rays)
    brute = intersect_brute(scene, rays)
    gv = np.asarray(got.valid)
    for ref in (walk, brute):
        np.testing.assert_array_equal(gv, np.asarray(ref.valid))
        np.testing.assert_allclose(
            np.asarray(got.t)[gv], np.asarray(ref.t)[gv], rtol=1e-5
        )
    # the same arithmetic in the same node order picks the same face,
    # ties included
    np.testing.assert_array_equal(
        np.asarray(got.face)[gv], np.asarray(walk.face)[gv]
    )
    if name in ("miss_only", "dead_lanes"):
        assert not gv.any()
    elif name != "maxt_clipped":
        assert gv.sum() >= 10, gv.sum()
    if name == "maxt_clipped":
        assert (np.asarray(got.t)[gv] <= 3.6).all()


def test_block_size_and_padding():
    """Lane counts below, at and past a block: the padded dead lanes
    change no real lane's result and are cut off again."""
    V, F = _spheres()
    b = bvh_mod.build_bvh(V, F)
    _, _, rays = _case("spheres")
    args = (b, rays.o, rays.d, rays.mint, rays.maxt)
    whole = np.asarray(walk_prims(*args, interpret=True))
    assert whole.shape == (256,) and whole.dtype == np.int32
    for n in (1, BLOCK - 1, BLOCK, BLOCK + 1):
        part = walk_prims(b, *(a[:n] for a in args[1:]), interpret=True)
        np.testing.assert_array_equal(np.asarray(part), whole[:n])


def test_packed_node_rows_decode():
    V, F = random_soup(120, 2)
    b = bvh_mod.build_bvh(V, F)
    rows = np.asarray(b.packed_nodes).reshape(-1, bvh_mod.NODE_W)
    ints = rows[:, 6:].view(np.int32)
    np.testing.assert_array_equal(rows[:, :3], np.asarray(b.bounds_min))
    np.testing.assert_array_equal(rows[:, 3:6], np.asarray(b.bounds_max))
    np.testing.assert_array_equal(ints[:, 0], np.asarray(b.skip))
    np.testing.assert_array_equal(ints[:, 1] & ((1 << 28) - 1), np.asarray(b.prim_offset))
    np.testing.assert_array_equal(ints[:, 1] >> 28, np.asarray(b.prim_count))
    tris = np.asarray(b.packed_tris).reshape(-1, bvh_mod.TRI_W)
    for k, field in enumerate((b.tri_p0, b.tri_e1, b.tri_e2)):
        np.testing.assert_array_equal(tris[:, 3 * k:3 * k + 3], np.asarray(field))


def _hit_loss(intersect, scene, o, d):
    """A loss of the hit's (t, u, v), differentiable in the rays."""
    h = intersect(scene, Rays(o=o, d=d, mint=jnp.full(o.shape[0], 1e-4),
                              maxt=jnp.full(o.shape[0], 3.0e38)))
    w = h.valid.astype(jnp.float32)
    return jnp.sum(w * (h.t + 0.5 * h.u - 0.25 * h.v))


def test_gradients_match_brute_oracle():
    V, F = _spheres()
    scene = _FakeScene(V, F, bvh_mod.build_bvh(V, F))
    _, _, rays = _case("spheres")
    g_kernel = jax.grad(functools.partial(_hit_loss, kernel, scene), (0, 1))(
        rays.o, rays.d)
    g_brute = jax.grad(
        functools.partial(_hit_loss, intersect_brute, scene), (0, 1)
    )(rays.o, rays.d)
    for a, b in zip(g_kernel, g_brute):
        assert np.abs(np.asarray(b)).max() > 0
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-4, atol=1e-5)


def test_reverse_mode_does_not_trace_the_kernel():
    V, F = _spheres()
    scene = _FakeScene(V, F, bvh_mod.build_bvh(V, F))
    _, _, rays = _case("spheres")
    jaxpr = jax.make_jaxpr(
        jax.grad(functools.partial(_hit_loss, kernel, scene), 0)
    )(rays.o, rays.d)
    text = str(jaxpr)
    assert text.count("pallas_call") == 1  # the forward walk only


@pytest.mark.parametrize(
    "platform,walk",
    [("cpu", bvh_mod.intersect_bvh), ("gpu", intersect_bvh_kernel), ("tpu", None)],
)
def test_backend_choice(platform, walk):
    if walk is None:
        with pytest.raises(RuntimeError, match="no trace backend"):
            backend.bvh_walk(platform)
    else:
        assert backend.bvh_walk(platform) is walk
    assert backend.trace_backend() == "xla"  # the tests run on the CPU


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_rule(env_set, monkeypatch, tmp_path):
    from kazen_tpu.utils import compile_cache

    updates = []
    monkeypatch.setattr(
        jax.config, "update", lambda *a: updates.append(a)
    )
    if env_set:
        monkeypatch.setenv(compile_cache.ENV, str(tmp_path))
        assert compile_cache.enable_compile_cache("x") == str(tmp_path)
        assert updates == []  # JAX reads the variable itself
    else:
        monkeypatch.delenv(compile_cache.ENV, raising=False)
        monkeypatch.setattr(compile_cache, "_configured", lambda: "")
        path = compile_cache.enable_compile_cache()
        assert path == os.path.join(REPO, ".jax_cache")
        assert updates == [("jax_compilation_cache_dir", path)]


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_refuses_without_gpu(alone, tmp_path):
    """No GPU -> exit code 1 and no result line, both in the checkout and
    as a lone copy of the script."""
    script = os.path.join(REPO, "chip_smoke.py")
    if alone:
        script = str(tmp_path / "chip_smoke.py")
        with open(os.path.join(REPO, "chip_smoke.py")) as src, open(script, "w") as dst:
            dst.write(src.read())
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, script], env=env, cwd=os.path.dirname(script),
        capture_output=True, text=True, timeout=300,
    )
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stderr
