"""CLI: ``python -m kazen_tpu.cli scene.xml [-o out.png]`` -- the analog of
the reference's ``kazen scene.xml`` (main.cpp:20-83)."""
from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(prog="kazen")
    ap.add_argument("scene", help="scene XML file")
    ap.add_argument("-o", "--output", default=None, help="output PNG/EXR path")
    ap.add_argument("--spp", type=int, default=None, help="override sample count")
    ap.add_argument("--platform", default=None, help="jax platform override")
    ap.add_argument(
        "--checkpoint", default=None, help="checkpoint file for resumable renders"
    )
    ap.add_argument(
        "--distributed",
        action="store_true",
        help="shard pixel lanes over all local devices",
    )
    args = ap.parse_args(argv)

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)

    from ..utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    from ..scene.xml_io import load_xml
    from ..scene.compiler import compile_scene
    from ..film import io as img_io

    t0 = time.time()
    scene = load_xml(args.scene)
    arrays, static = compile_scene(scene)
    print(
        f"[kazen] compiled scene: {int(arrays.F.shape[0])} faces, "
        f"{static.num_lights} lights, {static.num_materials} materials, "
        f"{static.width}x{static.height} @ {static.sample_count} spp "
        f"({time.time() - t0:.2f}s)",
        file=sys.stderr,
    )

    t0 = time.time()
    if args.distributed:
        from ..dist.sharding import make_mesh, render_distributed

        img = render_distributed(make_mesh(), arrays, static, spp=args.spp)
    elif args.checkpoint:
        from ..film.checkpoint import render_resumable

        img = render_resumable(
            arrays, static, spp=args.spp, checkpoint_path=args.checkpoint
        )
    else:
        from ..integrate.render import render

        img = render(arrays, static, spp=args.spp)
    import numpy as np

    img = np.asarray(img)
    dt = time.time() - t0
    spp = args.spp or static.sample_count
    mps = static.width * static.height * spp / dt
    print(
        f"[kazen] rendered in {dt:.2f}s "
        f"({mps / 1e6:.2f} Mpixel-samples/s)",
        file=sys.stderr,
    )

    out = args.output or (args.scene.rsplit(".", 1)[0] + ".png")
    if out.endswith(".exr"):
        img_io.save_exr(out, img)
    else:
        img_io.save_png(out, img)
    print(f"[kazen] wrote {out}", file=sys.stderr)


if __name__ == "__main__":
    main()
