"""Inverse rendering demo: recover scene parameters from a target image.

Renders a ground-truth image of the w3_test scene, perturbs the material
colors and a light position, then optimizes them back by gradient descent
through the differentiable renderer (soft shadows).  Saves a 3-panel strip
(target | start | recovered).

Usage: python examples/inverse_rendering.py [--steps 200] [--size 96x72]
       [--platform cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))  # repo root


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--size", default="96x72")
    p.add_argument("--out", default="inverse_rendering.png")
    p.add_argument("--platform", default=None, choices=["cpu", "gpu"])
    p.add_argument("--checkpoint-dir", default=None,
                   help="save/resume optimization state under this directory")
    p.add_argument("--checkpoint-every", type=int, default=50)
    args = p.parse_args(argv)
    if args.platform:
        import jax

        jax.config.update("jax_platforms", args.platform)

    import jax
    import jax.numpy as jnp
    import optax

    from raytpu.core import scenes
    from raytpu.core.types import RenderConfig
    from raytpu.grad import diff_render
    from raytpu.utils.image import write_png
    from raytpu.utils import compile_cache

    compile_cache.enable()

    w, h = (int(x) for x in args.size.lower().split("x"))
    cfg = RenderConfig(width=w, height=h, soft_shadows=True, soft_beta=60.0)
    truth = scenes.get("w3_test").build()
    target = diff_render.render_soft(truth, cfg)

    # perturb: wrong albedos + wrong first-light position
    rng = np.random.default_rng(0)
    bad_mats = dataclasses.replace(
        truth.materials,
        color=jnp.clip(truth.materials.color + jnp.asarray(rng.uniform(-0.5, 0.5, truth.materials.color.shape), jnp.float32), 0.05, 1.0),
    )
    bad_lights = dataclasses.replace(
        truth.lights, position=truth.lights.position + jnp.asarray([[1.5, -1.0, 0.5], [-1.0, 0.5, 1.0]], jnp.float32)
    )
    broken = dataclasses.replace(truth, materials=bad_mats, lights=bad_lights)
    start_img = diff_render.render_soft(broken, cfg)

    def params_of(s):
        return {"color": s.materials.color, "light_pos": s.lights.position}

    def merge(s, prm):
        mats = dataclasses.replace(s.materials, color=prm["color"])
        lights = dataclasses.replace(s.lights, position=prm["light_pos"])
        return dataclasses.replace(s, materials=mats, lights=lights)

    opt = optax.adam(2e-2)
    step = diff_render.make_train_step(cfg, opt, params_of, merge)
    params = params_of(broken)
    opt_state = opt.init(params)

    mgr = None
    start_step = 0
    if args.checkpoint_dir:
        from raytpu.utils.checkpoint import CheckpointManager

        mgr = CheckpointManager(args.checkpoint_dir, keep=3)
        resumed, state = mgr.restore_latest(like={"params": params, "opt_state": opt_state})
        if resumed is not None:
            start_step, params, opt_state = resumed, state["params"], state["opt_state"]
            print(f"resumed from checkpoint step {start_step}")

    t0 = time.perf_counter()
    loss = float("nan")
    for i in range(start_step, args.steps):
        params, opt_state, loss = step(params, opt_state, broken, target)
        if i % max(args.steps // 10, 1) == 0:
            print(f"step {i:4d}  loss {float(loss):.6f}")
        if mgr and (i + 1) % args.checkpoint_every == 0:
            mgr.save_step(i + 1, {"params": params, "opt_state": opt_state})
    print(f"final loss {float(loss):.6f} in {time.perf_counter()-t0:.1f}s")

    recovered = diff_render.render_soft(merge(broken, params), cfg)
    strip = np.concatenate(
        [np.asarray(x) for x in (target, start_img, recovered)], axis=1
    )
    write_png(args.out, (np.clip(strip, 0, 1) * 255).astype(np.uint8))
    print(f"wrote {args.out} (target | start | recovered)")

    err_color = float(jnp.abs(params["color"] - truth.materials.color).max())
    err_light = float(jnp.abs(params["light_pos"] - truth.lights.position).max())
    print(f"max param error: color {err_color:.3f}, light position {err_light:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
