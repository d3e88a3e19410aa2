#!/usr/bin/env python
"""Strong-scaling harness for the sample-sharded render (1 -> N devices).

Renders the same frame on one device and with the pixels x sample-batches
lane axis sharded over N devices via shard_map (dist/sharding.py:
render_sample_sharded) -- the wavefront's per-bounce permute is
shard-local and the only collective is the film psum. It reports the
wall-clock speedup, the image difference, and a census of the collectives
in the compiled sharded pass.

On virtual CPU devices (which share the host's cores) it checks the
program's structure, not its speed:
  XLA_FLAGS=--xla_force_host_platform_device_count=4 JAX_PLATFORMS=cpu \
  python benchmarks/scaling.py --devices 4
"""
import argparse
import json
import os
import re
import sys
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=None)
    ap.add_argument("--width", type=int, default=128)
    ap.add_argument("--height", type=int, default=96)
    ap.add_argument("--spp", type=int, default=8)
    ap.add_argument("--batches", type=int, default=2)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    sys.path.insert(0, os.path.join(root, "tests"))
    import scenes
    from kazen_tpu.dist.sharding import (
        jump_table, make_mesh, make_sample_lanes, render_sample_sharded,
        shard_mapped_pass,
    )
    from kazen_tpu.integrate.render import sampler_spec
    from kazen_tpu.scene.compiler import compile_scene

    n_dev = args.devices or len(jax.devices())
    if len(jax.devices()) < n_dev:
        sys.exit(f"need {n_dev} devices, have {len(jax.devices())}")

    desc = scenes.cornell_box(width=args.width, height=args.height)
    desc.meshes.append(scenes.sphere_mesh((0.3, 0.5, 0.3), 0.3, nu=16, nv=12))
    desc.meshes.append(scenes.sphere_mesh((-0.4, 1.2, 0.2), 0.25, nu=12, nv=10))
    arrays, static = compile_scene(desc)

    seconds, imgs = {}, {}
    for nd in sorted({1, n_dev}):
        mesh = make_mesh(jax.devices()[:nd])
        jax.block_until_ready(  # warmup / compile
            render_sample_sharded(mesh, arrays, static, spp=1, sample_batches=1)
        )
        t0 = time.perf_counter()
        img = render_sample_sharded(
            mesh, arrays, static, spp=args.spp, sample_batches=args.batches
        )
        imgs[nd] = np.asarray(img)
        seconds[nd] = time.perf_counter() - t0

    # The design claim (SURVEY §2.8): per-bounce work is shard-local and
    # the ONLY collective is the film all-reduce. Read it from the HLO.
    mesh = make_mesh(jax.devices()[:n_dev])
    px, py, batch = make_sample_lanes(static, n_dev, args.batches)
    lane = NamedSharding(mesh, P("devices"))
    jump_rows = np.asarray(jump_table(list(range(args.batches))))[batch]
    run = shard_mapped_pass(mesh, static, sampler_spec(static))
    hlo = run.lower(
        arrays,
        *(jax.device_put(jnp.asarray(x), lane) for x in (px, py, 0 * batch, jump_rows)),
    ).compile().as_text()
    census = {
        kind: len(re.findall(rf"\b{kind}", hlo))
        for kind in ("all-reduce", "all-to-all", "all-gather", "reduce-scatter",
                     "collective-permute")
    }
    speedup = seconds[1] / seconds[n_dev]
    dev = jax.devices()[0]
    print(json.dumps({
        "metric": f"wall-clock speedup 1->{n_dev} devices",
        "value": speedup,
        "efficiency": speedup / n_dev,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": n_dev},
        "seconds": seconds,
        "sharded_vs_one_device_max_abs_err": float(
            np.abs(imgs[1] - imgs[n_dev]).max()
        ),
        "collective_census": census,
        "size": f"{args.width}x{args.height}",
        "spp": args.spp,
        "sample_batches": args.batches,
    }))


if __name__ == "__main__":
    main()
