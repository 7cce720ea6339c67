"""Forward and inverse-rendering timings on the GPU: one JSON line.

Every phase runs in this one process, on the path the router picks
(``raytpu.render.route``), with the persistent compile cache enabled
(``raytpu.utils.compile_cache``).  Each phase compiles once (reported as
set-up), then times ``--repeats`` dispatches of a ``lax.scan`` over
``frames`` frames or steps, each ended by ``block_until_ready``.

Without a GPU it exits 1: a CPU timing is not a device number.

Phases (default: all):
  forward <scene> <WxH>  — routed forward frames (ms/frame, primary rays/s)
  grad    <scene> <WxH>  — soft-shadow material fwd+bwd steps (ms/step)

Usage: python bench.py                    # every phase, one JSON line
       python bench.py --scene bunny50k   # one forward phase
       python bench.py --scene optional --grad

Baseline: the reference's committed benchmark.txt average of 11.0285 FPS at
640x480 on its CPU => 3.388e6 primary rays/s (BASELINE.md).
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

BASELINE_PRIMARY_RAYS_PER_S = 11.0285 * 640 * 480  # reference benchmark.txt avg

# (kind, scene, size, frames per dispatch)
PHASES = [
    ("forward", "reference", "640x480", 64),
    ("forward", "bunny", "640x480", 16),
    ("forward", "bunny", "1920x1088", 8),
    ("forward", "optional", "640x480", 16),
    ("forward", "bunny50k", "640x480", 4),
    ("forward", "bunny300k", "640x480", 2),
    ("grad", "bunny", "640x480", 8),
    ("grad", "optional", "640x480", 4),
]


def _timed(fn, repeats):
    """(compile seconds, median seconds per dispatch, samples)."""
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(fn())
    compile_s = time.perf_counter() - t0
    samples = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        samples.append(time.perf_counter() - t0)
    return compile_s, statistics.median(samples), samples


def phase_forward(scene_name, size, frames, repeats, trace=None):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from raytpu.core import scenes
    from raytpu.core.types import RenderConfig
    from raytpu.render import route

    w, h = (int(x) for x in size.lower().split("x"))
    config = RenderConfig(width=w, height=h)
    spec = scenes.get(scene_name)
    scene = spec.build()

    @jax.jit
    def run(s):
        def body(carry, t):
            img = route.render_image_f32(spec.animate(s, t), config)
            return carry + jnp.sum(img), None

        return jax.lax.scan(body, jnp.float32(0.0), jnp.linspace(0.0, 2.0 * np.pi, frames))[0]

    compile_s, med, samples = _timed(lambda: run(scene), repeats)
    if trace:
        from raytpu.utils.profiling import trace as profile_trace

        with profile_trace(trace):
            jax.block_until_ready(run(scene))
    return {"kind": "forward", "scene": scene_name, "size": size,
            "route": route.kind(scene, config), "compile_s": compile_s,
            "ms_per_frame": med * 1e3 / frames, "rays_per_s": frames / med * w * h,
            "samples": len(samples)}


def phase_grad(scene_name, size, frames, repeats):
    """fwd+bwd ms/step: soft-shadow material-fit steps, K per dispatch."""
    import jax
    import jax.numpy as jnp

    from raytpu.core import scenes
    from raytpu.core.types import RenderConfig
    from raytpu.grad import diff_render

    w, h = (int(x) for x in size.lower().split("x"))
    cfg = RenderConfig(width=w, height=h, soft_shadows=True)
    scene = scenes.get(scene_name).build()
    target = jnp.zeros((h, w, 3), jnp.float32)

    def loss_fn(params):
        s = diff_render.merge_material_params(scene, params)
        return jnp.mean((diff_render.render_soft_f32(s, cfg) - target) ** 2)

    @jax.jit
    def steps(params):
        def body(p, _):
            loss, g = jax.value_and_grad(loss_fn)(p)
            return jax.tree_util.tree_map(lambda x, gx: x - 1e-2 * gx, p, g), loss

        return jax.lax.scan(body, params, None, length=frames)

    params = diff_render.material_params(scene)
    compile_s, med, samples = _timed(lambda: steps(params), repeats)
    return {"kind": "grad", "scene": scene_name, "size": size, "compile_s": compile_s,
            "ms_per_step": med * 1e3 / frames, "samples": len(samples)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--scene", default=None, help="run ONE phase on this scene")
    p.add_argument("--size", default="640x480")
    p.add_argument("--frames", type=int, default=16, help="frames (steps) per dispatch")
    p.add_argument("--repeats", type=int, default=5, help="timed dispatches (median taken)")
    p.add_argument("--grad", action="store_true", help="time fwd+bwd steps instead")
    p.add_argument("--trace", metavar="DIR", default=None,
                   help="capture a jax.profiler trace of one forward dispatch into DIR")
    args = p.parse_args(argv)

    from raytpu.utils import compile_cache, device

    compile_cache.enable()
    desc = device.require_gpu()
    print(f"device: {desc} card: {device.card_name_and_power_limit()}", file=sys.stderr)

    if args.scene is None:
        phases = PHASES
    else:
        phases = [("grad" if args.grad else "forward", args.scene, args.size, args.frames)]
    results = []
    for kind, scene, size, frames in phases:
        if kind == "grad":
            rec = phase_grad(scene, size, frames, args.repeats)
        else:
            rec = phase_forward(scene, size, frames, args.repeats, trace=args.trace)
        print(json.dumps(rec), file=sys.stderr)
        results.append(rec)

    head = next((r for r in results if r["kind"] == "forward"), None)
    line = {"metric": "primary_rays_per_s", "unit": "rays/s", "device": desc,
            "card": device.card_name_and_power_limit(), "phases": results}
    if head is not None:
        line.update(value=head["rays_per_s"],
                    vs_baseline=head["rays_per_s"] / BASELINE_PRIMARY_RAYS_PER_S)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
