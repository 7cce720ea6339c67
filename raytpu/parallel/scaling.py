"""Scaling-efficiency harness: rays/s at 1 device vs N devices.

Measures the sharded renderer over growing device meshes and reports
throughput + parallel efficiency.  On a CPU it runs against the virtual
CPU mesh, which validates function only: its rates are not device numbers.
On a multi-GPU host the same code measures real scaling over NVLink.

Usage: python -m raytpu.parallel.scaling --scene reference --size 640x480
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import jax

from raytpu.core import scenes
from raytpu.core.types import RenderConfig
from raytpu.parallel.sharding import make_mesh, _render_sharded_jit


def measure(scene, config, mesh, frames=4, repeats=2):
    out = _render_sharded_jit(scene, config, mesh)
    jax.block_until_ready(out)
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(frames):
            out = _render_sharded_jit(scene, config, mesh)
        jax.block_until_ready(out)
        best = min(best, (time.perf_counter() - t0) / frames)
    return config.width * config.height / best  # primary rays/s


def scaling_report(scene_name="reference", size=(256, 192), prim=1, frames=4):
    scene = scenes.get(scene_name).build()
    config = RenderConfig(width=size[0], height=size[1])
    n = len(jax.devices())
    rows = []
    counts = [c for c in (1, 2, 4, 8, 16, 32) if c <= n]
    base = None
    for c in counts:
        if c % prim:
            continue
        mesh = make_mesh(px=c // prim, prim=prim, devices=jax.devices()[:c])
        rps = measure(scene, config, mesh, frames=frames)
        base = base or rps
        rows.append(
            {
                "devices": c,
                "primary_rays_per_s": rps,
                "speedup": rps / base,
                "efficiency": rps / (base * c),
            }
        )
    return rows


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--scene", default="reference")
    p.add_argument("--size", default="256x192")
    p.add_argument("--prim", type=int, default=1)
    p.add_argument("--frames", type=int, default=4)
    p.add_argument("--platform", default=None)
    args = p.parse_args(argv)
    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    w, h = (int(x) for x in args.size.lower().split("x"))
    rows = scaling_report(args.scene, (w, h), args.prim, args.frames)
    for r in rows:
        print(json.dumps(r))
    return 0


if __name__ == "__main__":
    sys.exit(main())
