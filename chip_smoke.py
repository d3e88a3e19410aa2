#!/usr/bin/env python
"""Smoke test of the render path on one GPU (``--four``: four GPUs).

    python chip_smoke.py           # phases 0-5 on one card
    python chip_smoke.py --four    # the multi-card path only, on four cards

Phases (each prints its result beside the card's name and power limit):

0. device: JAX must see GPUs; otherwise exit 1 without a result.
1. trace: the GPU BVH walk against the XLA walk (the plain reference) on
   the 1080p camera rays and one bounce of the seeded 36,876-face
   look-dev scene (examples/baseline_configs.lookdev_scene).
2. render: ``render()`` at 1920x1080, depth 5, 4 spp, against the same
   render through the XLA walk.
3. platform parity: the scene at 160x90, 4 spp, on the card and in a CPU
   child process (JAX_PLATFORMS=cpu, so it never opens the card).
4. CLI: the scene written as XML + OBJ + EXR textures, rendered through
   ``kazen_tpu.cli.main.main`` in this process.
5. gradient: one ``dist.sharding.inverse_train_step`` on a 1-card mesh at
   256x256, depth 3; at 32x32 its loss and gradients against the CPU
   child's.

Any failed check raises, so the script exits non-zero. The last line of
standard output is one JSON object: {"ok": true, "device": {...}}.
"""
import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
for _p in (ROOT, os.path.join(ROOT, "tests"), os.path.join(ROOT, "examples")):
    sys.path.insert(0, _p)

import numpy as np  # noqa: E402

CARD = ""


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    global CARD
    if not CARD:
        CARD = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
        ).stdout.strip().splitlines()[0]
    return CARD


def report(phase, **fields):
    print(f"phase {phase}: {json.dumps(fields)}  [card: {card()}]", flush=True)


def check(ok, what):
    if not ok:
        raise AssertionError(what)


def timed(fn, *args, reps=5):
    """(first call seconds, median of ``reps`` further calls)."""
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return first, float(np.median(times))


def scene(width, height, spp=4, max_depth=5):
    import baseline_configs
    from kazen_tpu.scene.compiler import compile_scene

    return compile_scene(
        baseline_configs.lookdev_scene(width, height, spp, max_depth)
    )


@contextlib.contextmanager
def xla_walk():
    """Route every BVH trace through the XLA walk (the plain reference)."""
    import jax

    from kazen_tpu.accel import backend, bvh

    saved = backend.bvh_walk
    backend.bvh_walk = lambda platform=None: bvh.intersect_bvh
    jax.clear_caches()
    try:
        yield
    finally:
        backend.bvh_walk = saved
        jax.clear_caches()


def jump(sample):
    import jax.numpy as jnp

    from kazen_tpu.core import rng

    a, c = rng.advance_constants(sample * 65536)
    return (
        (jnp.uint32(a >> 32), jnp.uint32(a & 0xFFFFFFFF)),
        (jnp.uint32(c >> 32), jnp.uint32(c & 0xFFFFFFFF)),
    )


def camera_and_bounce(arrays, static):
    """Camera rays of sample 0 and the path rays after one bounce."""
    import jax
    import jax.numpy as jnp

    from kazen_tpu.accel.intersect import Rays
    from kazen_tpu.integrate import camera as camera_mod
    from kazen_tpu.integrate import path_mis
    from kazen_tpu.integrate.render import sampler_spec
    from kazen_tpu.samplers import streams

    spec = sampler_spec(static)

    @jax.jit
    def make(scene):
        n = static.width * static.height
        px = (jnp.arange(n) % static.width).astype(jnp.uint32)
        py = (jnp.arange(n) // static.width).astype(jnp.uint32)
        st = streams.init_stream_jump(spec, px, py, jnp.uint32(0), jump(0))
        st, jit_ = streams.next_pixel_2d(spec, st)
        ps = jnp.stack([px, py], -1).astype(jnp.float32) + jit_
        st, ap = streams.next_2d(spec, st)
        cam = camera_mod.sample_ray(scene, static, ps, ap)
        ws = path_mis.wavefront_init(scene, static, spec, st, cam)
        ws = path_mis._bounce_ordered(scene, static, spec, ws, draw_rr=False)
        bounce = Rays(
            o=ws.ray_o, d=ws.ray_d,
            mint=jnp.full(n, static.trace_bias, jnp.float32),
            maxt=jnp.where(ws.alive, path_mis.INF, -1.0),
        )
        return cam, bounce

    return make(arrays)


def phase_trace(arrays, static):
    import jax

    from kazen_tpu.accel import backend, bvh

    walk = jax.jit(backend.bvh_walk())
    ref = jax.jit(bvh.intersect_bvh)
    for name, rays in zip(("camera", "bounce"), camera_and_bounce(arrays, static)):
        _, t_walk = timed(walk, arrays, rays)
        _, t_ref = timed(ref, arrays, rays)
        got, want = walk(arrays, rays), ref(arrays, rays)
        gv, gf, gt = (np.asarray(x) for x in (got.valid, got.face, got.t))
        rv, rf, rt = (np.asarray(x) for x in (want.valid, want.face, want.t))
        agree = (gv == rv) & (~rv | (gf == rf))
        both = agree & rv
        rel_dt = float(
            np.max(np.abs(gt[both] - rt[both]) / np.maximum(np.abs(rt[both]), 1e-6))
        ) if both.any() else 0.0
        report(
            1, rays=name, lanes=int(gv.size), hits=int(rv.sum()),
            walk=backend.trace_backend(), walk_s=t_walk, xla_walk_s=t_ref,
            face_agreement=float(agree.mean()), max_rel_dt=rel_dt,
        )
        # exact edge ties may pick another face
        check(agree.mean() >= 0.9999, f"{name}: faces agree on {agree.mean():.6f}")
        check(rel_dt <= 1e-5, f"{name}: relative |dt| {rel_dt:.3g} > 1e-5")


def render_timed(arrays, static, spp):
    """(image, compile seconds, steady seconds per 1-spp pass)."""
    from kazen_tpu.integrate.render import render

    t0 = time.perf_counter()
    np.asarray(render(arrays, static, spp=1))
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    img = np.asarray(render(arrays, static, spp=spp))
    per_pass = (time.perf_counter() - t0) / spp
    return img, first - per_pass, per_pass


def phase_render(arrays, static):
    img, compile_s, pass_s = render_timed(arrays, static, 4)
    with xla_walk():
        ref, ref_compile_s, ref_pass_s = render_timed(arrays, static, 4)
    rel = float(np.abs(img - ref).mean() / np.abs(ref).mean())
    report(
        2, resolution=f"{static.width}x{static.height}",
        depth=static.max_depth, spp=4, mean=float(img.mean()),
        compile_s=compile_s, pass_s=pass_s,
        xla_walk_compile_s=ref_compile_s, xla_walk_pass_s=ref_pass_s,
        mean_rel_diff_vs_xla_walk=rel,
    )
    check(np.isfinite(img).all(), "render has non-finite pixels")
    check(img.mean() > 0.0, "render is black")
    # a face tie can flip a Russian-roulette or lobe decision downstream
    check(rel <= 1e-3, f"mean relative difference {rel:.3g} > 1e-3")


def grad_step(arrays, static, devices):
    """Loss and gradients of one inverse_train_step against a flat 0.3
    target, with the pixel lanes sharded over ``devices``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from kazen_tpu.dist.sharding import inverse_train_step, make_mesh
    from kazen_tpu.integrate.render import sampler_spec

    mesh = make_mesh(devices)
    step = inverse_train_step(mesh, arrays, static, sampler_spec(static))
    n = static.width * static.height
    lane = NamedSharding(mesh, P("devices"))
    px = jax.device_put(jnp.asarray(np.arange(n) % static.width, jnp.uint32), lane)
    py = jax.device_put(jnp.asarray(np.arange(n) // static.width, jnp.uint32), lane)
    target = jnp.full((static.height, static.width, 3), 0.3, jnp.float32)
    loss, grads = step(arrays, target, px, py, jnp.uint32(0), jump(0))
    return float(loss), {k: np.asarray(v) for k, v in grads.items()}


def cpu_reference(out_dir):
    """Runs in the CPU child: the phase-3 render and phase-5 gradients.
    It keeps to half the host's cores, so the GPU phases running beside
    it keep the other half."""
    cores = sorted(os.sched_getaffinity(0))
    os.sched_setaffinity(0, cores[len(cores) // 2:] or cores)
    import jax

    from kazen_tpu.integrate.render import render

    arrays, static = scene(160, 90)
    np.save(os.path.join(out_dir, "render.npy"), np.asarray(render(arrays, static, spp=4)))
    arrays, static = scene(32, 32, spp=1, max_depth=3)
    loss, grads = grad_step(arrays, static, jax.devices()[:1])
    np.savez(os.path.join(out_dir, "grads.npz"), loss=loss, **grads)


def start_cpu_child(out_dir):
    # No persistent cache in the child: XLA:CPU executables compiled on
    # another host can load and compute wrong results.
    env = dict(os.environ, JAX_PLATFORMS="cpu", JAX_ENABLE_COMPILATION_CACHE="0")
    with open(os.path.join(out_dir, "child.log"), "w") as log:
        return subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--cpu-reference", out_dir],
            env=env, stdout=log, stderr=subprocess.STDOUT,
        )


def wait_child(child, out_dir):
    child.wait(timeout=900)
    with open(os.path.join(out_dir, "child.log")) as log:
        check(child.returncode == 0, f"CPU child failed:\n{log.read()[-3000:]}")


def phase_platform(out_dir):
    from kazen_tpu.integrate.render import render

    arrays, static = scene(160, 90)
    img = np.asarray(render(arrays, static, spp=4))
    ref = np.load(os.path.join(out_dir, "render.npy"))
    mean_rel = float(abs(img.mean() - ref.mean()) / ref.mean())
    close = float((np.abs(img - ref).max(-1) <= 1e-2).mean())
    report(3, resolution="160x90", spp=4, gpu_mean=float(img.mean()),
           cpu_mean=float(ref.mean()), mean_rel_diff=mean_rel,
           pixels_within_1e_2=close)
    # operation order and FMA contraction differ between the platforms,
    # and a flipped face tie changes a whole path
    check(mean_rel <= 1e-3, f"GPU/CPU image means differ by {mean_rel:.3g}")
    check(close >= 0.99, f"only {close:.4f} of pixels within 1e-2")


def write_scene_files(desc, out_dir, width, height, spp):
    """The scene description as XML + one OBJ per mesh + EXR textures."""
    from kazen_tpu.film.io import save_exr
    from kazen_tpu.scene import description as D

    def obj(i, mesh):
        name = f"mesh{i}.obj"
        with open(os.path.join(out_dir, name), "w") as f:
            f.writelines(f"v {x:.9g} {y:.9g} {z:.9g}\n" for x, y, z in mesh.vertices)
            f.writelines(f"vt {u:.9g} {v:.9g}\n" for u, v in mesh.uvs)
            f.writelines(f"vn {x:.9g} {y:.9g} {z:.9g}\n" for x, y, z in mesh.normals)
            f.writelines(
                "f " + " ".join(f"{k + 1}/{k + 1}/{k + 1}" for k in tri) + "\n"
                for tri in mesh.faces
            )
        return name

    def texture(tex, tid, key):
        if isinstance(tex, D.ImageTexture):
            name = f"tex_{key}.exr"
            save_exr(os.path.join(out_dir, name), tex.data)
            return (f'<texture type="imagetexture" id="{tid}">'
                    f'<string name="filename" value="{name}"/>'
                    '<string name="colorspace" value="linear"/></texture>')
        c = " ".join(f"{x:.9g}" for x in tex.color)
        return (f'<texture type="constanttexture" id="{tid}">'
                f'<color name="color" value="{c}"/></texture>')

    def bsdf(b, key):
        if isinstance(b, D.Diffuse):
            c = " ".join(f"{x:.9g}" for x in b.albedo)
            return f'<bsdf type="diffuse"><color name="albedo" value="{c}"/></bsdf>'
        if isinstance(b, D.NormalMap):
            return ('<bsdf type="normalmap">' + bsdf(b.nested, key + "n")
                    + texture(b.normals, "normals", key) + "</bsdf>")
        assert isinstance(b, D.KazenStandard), type(b)
        floats = "".join(
            f'<float name="{n}" value="{getattr(b, a)}"/>'
            for n, a in (("clearcoat", "clearcoat"), ("sheen", "sheen"))
        )
        return ('<bsdf type="kazenstandard">' + floats
                + texture(b.base_color, "baseColor", key + "b")
                + texture(b.metallic, "metallic", key + "m")
                + texture(b.roughness, "roughness", key + "r") + "</bsdf>")

    cam = desc.camera
    m = " ".join(f"{x:.9g}" for x in np.asarray(cam.to_world).reshape(-1))
    parts = [
        '<?xml version="1.0"?>', "<scene>",
        f'<integrator type="path_mis"><integer name="maxDepth" '
        f'value="{desc.integrator.max_depth}"/></integrator>',
        f'<sampler type="{desc.sampler.kind}"><integer name="sampleCount" '
        f'value="{spp}"/></sampler>',
        f'<camera type="thinlens"><integer name="width" value="{width}"/>'
        f'<integer name="height" value="{height}"/>'
        f'<float name="fov" value="{cam.fov}"/>'
        f'<float name="apertureRadius" value="{cam.aperture_radius}"/>'
        f'<float name="focusDistance" value="{cam.focus_distance}"/>'
        f'<transform name="toWorld"><matrix value="{m}"/></transform>'
        f'<rfilter type="{desc.rfilter.kind}"/></camera>',
    ]
    for i, mesh in enumerate(desc.meshes):
        body = bsdf(mesh.bsdf, str(i))
        if mesh.light is not None:
            c = " ".join(f"{x:.9g}" for x in mesh.light.color)
            body += (f'<light type="area"><color name="color" value="{c}"/>'
                     f'<float name="intensity" value="{mesh.light.intensity}"/></light>')
        parts.append(f'<mesh type="obj"><string name="filename" '
                     f'value="{obj(i, mesh)}"/>{body}</mesh>')
    parts.append("</scene>")
    path = os.path.join(out_dir, "lookdev.xml")
    with open(path, "w") as f:
        f.write("\n".join(parts))
    return path


def phase_cli(out_dir):
    import baseline_configs
    from kazen_tpu.cli.main import main
    from kazen_tpu.film.io import load_png

    width, height = 320, 180
    xml = write_scene_files(
        baseline_configs.lookdev_scene(), out_dir, width, height, spp=1
    )
    png = os.path.join(out_dir, "lookdev.png")
    t0 = time.perf_counter()
    main([xml, "-o", png])
    seconds = time.perf_counter() - t0
    check(os.path.exists(png), "CLI wrote no PNG")
    img = load_png(png)
    report(4, png_shape=list(img.shape), seconds=seconds, mean=float(img.mean()))
    check(img.shape == (height, width, 3), f"PNG shape {img.shape}")
    check(img.mean() > 0, "CLI image is black")


def check_grads(loss, grads, ref_loss, ref_grads, rtol, what):
    check(abs(loss - ref_loss) <= rtol * abs(ref_loss),
          f"{what}: loss {loss} vs {ref_loss}")
    for k, ref in ref_grads.items():
        # relative to the field's largest entry: entries near zero are
        # sums whose terms cancel
        scale = max(float(np.abs(ref).max()), 1e-12)
        err = float(np.abs(grads[k] - ref).max()) / scale
        check(err <= rtol, f"{what}: gradient {k} differs by {err:.3g}")


def phase_gradient(out_dir):
    import jax

    arrays, static = scene(256, 256, spp=1, max_depth=3)
    t0 = time.perf_counter()
    loss, grads = grad_step(arrays, static, jax.devices()[:1])
    seconds = time.perf_counter() - t0
    finite = all(np.isfinite(g).all() for g in grads.values())
    gnorm = float(np.sqrt(sum(float((g * g).sum()) for g in grads.values())))
    check(np.isfinite(loss) and finite, "non-finite loss or gradient")
    check(gnorm > 0, "all gradients are zero")
    arrays, static = scene(32, 32, spp=1, max_depth=3)
    loss32, grads32 = grad_step(arrays, static, jax.devices()[:1])
    ref = np.load(os.path.join(out_dir, "grads.npz"))
    ref_grads = {k: ref[k] for k in ref.files if k != "loss"}
    report(5, resolution="256x256", depth=3, loss=loss, grad_norm=gnorm,
           seconds_with_compile=seconds, loss_32=loss32,
           cpu_loss_32=float(ref["loss"]))
    check_grads(loss32, grads32, float(ref["loss"]), ref_grads, 1e-3,
                "32x32 GPU vs CPU")


def phase_four():
    """The multi-card path users reach through ``--distributed`` and
    dist/sharding.py, against one card."""
    import jax

    from kazen_tpu.dist.sharding import (
        make_mesh, render_distributed, render_sample_sharded,
    )
    from kazen_tpu.film.film import filter_radius
    from kazen_tpu.integrate.render import render

    devices = jax.devices()
    check(len(devices) == 4, f"--four needs 4 GPUs, found {len(devices)}")
    # phase 2's scene, so one card's pass is the one phase 2 compiled
    arrays, static = scene(1920, 1080)
    spp = 2
    mesh = make_mesh(devices)
    runs = {
        "render_1_card": lambda: render(arrays, static, spp=spp),
        "render_distributed": lambda: render_distributed(
            mesh, arrays, static, spp=spp),
        "render_sample_sharded": lambda: render_sample_sharded(
            mesh, arrays, static, spp=spp, sample_batches=spp),
    }
    # A few ulp per pixel: the film sums are added in another order
    # (scatter-add, psum), and the separately compiled programs may round
    # a lane's last bit differently. A pixel sums spp samples times the
    # filter taps that reach it, in two accumulators (value, weight) that
    # are then divided. A sample credited to another pixel, or a path
    # that takes another turn, is far outside this bound.
    taps = (2 * int(filter_radius(static) + 0.5) + 1) ** 2
    rtol = (2 * spp * taps + 1) * 2.0**-24
    ref = None
    for name, run in runs.items():
        t0 = time.perf_counter()
        img = np.asarray(run())
        first = time.perf_counter() - t0
        t0 = time.perf_counter()
        jax.block_until_ready(run())
        second = time.perf_counter() - t0
        report("four", run=name, spp=spp, first_call_s=first,
               second_call_s=second, mean=float(img.mean()))
        if ref is None:
            ref = img
            continue
        diff = np.abs(img - ref)
        over = diff > rtol * np.abs(ref)
        report("four", compare=f"{name} vs render_1_card", rtol=rtol,
               max_abs_diff=float(diff.max()),
               pixels_differing=int((diff > 0).any(-1).sum()),
               pixels_over_rtol=int(over.any(-1).sum()))
        check(not over.any(), f"{name}: {int(over.any(-1).sum())} pixels "
              f"differ from one card by more than {rtol:.3g} relative")
    arrays, static = scene(256, 256, spp=1, max_depth=3)
    t0 = time.perf_counter()
    loss4, grads4 = grad_step(arrays, static, devices)
    seconds4 = time.perf_counter() - t0
    loss1, grads1 = grad_step(arrays, static, devices[:1])
    report("four", run="inverse_train_step", resolution="256x256", depth=3,
           loss_4=loss4, loss_1=loss1, seconds_with_compile_4=seconds4)
    # the four partial gradients (sums over 65,536 lanes each way) are
    # all-reduced in another order than one card's sum
    check_grads(loss4, grads4, loss1, grads1, 1e-3, "4 cards vs 1")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card path and its comparison")
    ap.add_argument("--cpu-reference", metavar="DIR", help=argparse.SUPPRESS)
    args = ap.parse_args()

    import jax

    if args.cpu_reference:
        cpu_reference(args.cpu_reference)
        return

    # phase 0: a GPU, or nothing
    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU visible to JAX (found {devices[0].platform}); "
              "nothing was run", file=sys.stderr)
        sys.exit(1)
    from kazen_tpu.utils.compile_cache import enable_compile_cache

    report(0, jax=jax.__version__, devices=len(devices),
           kind=devices[0].device_kind, compile_cache=enable_compile_cache())

    if args.four:
        phase_four()
    else:
        with tempfile.TemporaryDirectory() as tmp:
            child = start_cpu_child(tmp)
            try:
                arrays, static = scene(1920, 1080)
                phase_trace(arrays, static)
                phase_render(arrays, static)
                del arrays
                wait_child(child, tmp)
                phase_platform(tmp)
                phase_cli(tmp)
                phase_gradient(tmp)
            finally:
                if child.poll() is None:
                    child.kill()
                    child.wait()
    card()
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }}))


if __name__ == "__main__":
    main()
