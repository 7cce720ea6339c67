"""Command-line frame loop — the app shell replacing the reference's SDL
window + key toggles (reference: source/main.cpp:23-121).

The reference's compile-time #defines and runtime F-keys become flags:
  --scene       scene registry name        (was: editing main.cpp:48)
  --size WxH    resolution                 (was: literals main.cpp:32-33)
  --mode        lighting debug mode        (was: F3 cycle)
  --no-shadows  disable shadow rays        (was: F2 toggle)
  --screenshot  save frame to BMP/PNG      (was: X key)
  --benchmark N FPS benchmark -> file      (was: F6)
  --frames N    run N animated frames
  --watch       print FPS once per second  (was: main.cpp:95-100)

Usage: python -m raytpu.app.cli --scene reference --size 640x480 --benchmark 10
"""

from __future__ import annotations

import argparse
import functools
import sys
import time

import numpy as np

from raytpu.core import scenes
from raytpu.core.types import LightingMode, RenderConfig
from raytpu.utils import compile_cache, image as image_io
from raytpu.utils.profiling import Benchmark, FrameTimer, RayStats


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="raytpu", description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--scene", default="reference", choices=sorted(scenes.REGISTRY), help="scene fixture")
    p.add_argument("--size", default="640x480", help="WxH resolution")
    p.add_argument(
        "--mode",
        default="combined",
        choices=["observed_area", "radiance", "brdf", "combined"],
        help="lighting debug mode (reference: F3)",
    )
    p.add_argument("--no-shadows", action="store_true", help="disable shadow rays (reference: F2)")
    p.add_argument("--soft-shadows", action="store_true",
                   help="sigmoid soft-shadow visibility (the differentiable "
                        "path's shading; a capability the reference lacks)")
    p.add_argument("--soft-beta", type=float, default=None, metavar="B",
                   help="soft-shadow sigmoid sharpness (default 300; lower = softer)")
    p.add_argument("--frames", type=int, default=1, help="number of animated frames to render")
    p.add_argument("--frames-per-dispatch", type=int, default=1, metavar="K",
                   help="render K animated frames per device dispatch "
                        "(lax.scan) to amortize the per-dispatch host "
                        "latency; animation time within a dispatch advances "
                        "by the previous dispatch's measured per-frame wall time")
    p.add_argument("--screenshot", metavar="PATH", default=None, help="save the last frame (BMP or PNG)")
    p.add_argument("--benchmark", type=int, metavar="N", default=0, help="run an N-sample FPS benchmark (reference: F6)")
    p.add_argument("--benchmark-out", default="benchmark.txt", help="benchmark report path")
    p.add_argument("--watch", action="store_true", help="print FPS once per second")
    p.add_argument("--renderer", default="auto", choices=["auto", "jnp"],
                   help="auto: the route picks the culled sweep or jnp per "
                        "scene (raytpu.render.route); jnp: force the dense path")
    p.add_argument("--shard", metavar="PXxPRIM", default=None,
                   help="render on a (px, prim) device mesh via shard_map "
                        "(e.g. 2x2: rays over 2 devices x triangles over 2); "
                        "the multi-device analog of the reference's CPU-thread "
                        "pixel fan-out (source/Renderer.cpp:42-92)")
    p.add_argument("--ssaa", type=int, default=1, metavar="N", help="NxN supersampling per pixel")
    p.add_argument("--time", type=float, default=0.0, help="animation start time (seconds)")
    p.add_argument("--platform", default=None, choices=["cpu", "gpu"],
                   help="force a JAX platform: cpu, gpu")
    return p


_MODES = {
    "observed_area": LightingMode.OBSERVED_AREA,
    "radiance": LightingMode.RADIANCE,
    "brdf": LightingMode.BRDF,
    "combined": LightingMode.COMBINED,
}


def sweep_option(renderer: str):
    """``--renderer`` -> the ``sweep`` argument of the routed renderers."""
    return False if renderer == "jnp" else None


def make_render_fn(renderer: str):
    """(scene, config) -> uint8 image on the routed path."""
    from raytpu.render import route

    return functools.partial(route.render_image, sweep=sweep_option(renderer))


def main(argv=None) -> int:
    args = build_arg_parser().parse_args(argv)
    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    compile_cache.enable()
    try:
        w, h = (int(x) for x in args.size.lower().split("x"))
    except ValueError:
        print(f"error: --size must be WxH (got {args.size!r})", file=sys.stderr)
        return 2
    if w <= 0 or h <= 0:
        print(f"error: --size must be positive (got {args.size!r})", file=sys.stderr)
        return 2
    if args.ssaa < 1:
        print(f"error: --ssaa must be >= 1 (got {args.ssaa})", file=sys.stderr)
        return 2
    soft_kw = {}
    if args.soft_shadows:
        soft_kw["soft_shadows"] = True
        if args.soft_beta is not None:
            soft_kw["soft_beta"] = float(args.soft_beta)
    config = RenderConfig(width=w, height=h, lighting_mode=_MODES[args.mode],
                          shadows=not args.no_shadows, **soft_kw)
    spec = scenes.get(args.scene)
    scene = spec.build()
    from raytpu.render import route

    sweep = sweep_option(args.renderer)
    backend = route.kind(scene, config, sweep)
    if args.shard:
        from raytpu.parallel import make_mesh, render_image_sharded
        from raytpu.parallel.sharding import _render_sharded_jit

        try:
            px, prim = (int(x) for x in args.shard.lower().split("x"))
            mesh = make_mesh(px=px, prim=prim)
        except (ValueError, AssertionError) as e:
            print(f"error: --shard must be PXxPRIM matching the device count ({e})",
                  file=sys.stderr)
            return 2
        render_fn = functools.partial(render_image_sharded, mesh=mesh, sweep=sweep)
        # SSAA composes with sharding: the supersampled grid is just a bigger
        # ray grid for the px axis (box filter applied after the gather)
        base_f32 = functools.partial(_render_sharded_jit, mesh=mesh, sweep=sweep)
        backend = f"shard({px}x{prim},{backend})"
    else:
        render_fn = make_render_fn(args.renderer)
        base_f32 = functools.partial(route.render_image_f32, sweep=sweep)
    if args.ssaa > 1:
        from raytpu.render.renderer import render_image_ssaa

        render_fn = functools.partial(render_image_ssaa, samples=args.ssaa, render_fn=base_f32)
    print(f"raytpu: scene={args.scene} {w}x{h} mode={args.mode} shadows={config.shadows} "
          f"backend={backend} ssaa={args.ssaa} platform={jax.default_backend()}")

    # warm-up / compile
    t0 = time.perf_counter()
    img = np.asarray(render_fn(spec.animate(scene, args.time), config))
    warm_s = time.perf_counter() - t0
    print(f"compile+first frame: {warm_s:.2f}s")

    K = max(args.frames_per_dispatch, 1)
    scan_render = None
    if K > 1:
        import jax.numpy as jnp

        base_render = render_fn
        init_img = jnp.zeros(img.shape, img.dtype)

        @jax.jit
        def scan_render(s, ts):
            def body(_, t):
                return base_render(spec.animate(s, t), config), None

            out, _ = jax.lax.scan(body, init_img, ts)
            return out  # last frame of the dispatch

        t0 = time.perf_counter()
        img = np.asarray(scan_render(scene, jnp.full((K,), np.float32(args.time))))
        print(f"compile scan dispatch (K={K}): {time.perf_counter()-t0:.2f}s")

    timer = FrameTimer()
    bench = Benchmark(args.benchmark) if args.benchmark else None
    if bench:
        print(f"**BENCHMARK STARTED ({args.benchmark} samples)**")
        bench.start()
    stats = RayStats()

    n_frames = max(args.frames, 1)
    frame = 0
    # per-frame wall estimate for in-dispatch animation times; clamped like
    # the reference's elapsed upper bound (source/Timer.cpp:83-89) so the
    # compile-inclusive warm-up can't fling the first dispatch's animation
    # times tens of seconds apart
    dt_est = min(warm_s, 0.5)
    done = False
    while not done:
        t = args.time + timer.total
        # frames this dispatch actually advances (the scan still runs K
        # frames; a tail dispatch repeats the last requested time so the
        # final frame/screenshot matches the K=1 loop's last frame)
        j = K if bench else min(K, n_frames - frame)
        ft0 = time.perf_counter()
        if K > 1:
            import jax.numpy as jnp

            ts = np.float32(t) + np.float32(dt_est) * np.minimum(
                np.arange(K, dtype=np.float32), np.float32(j - 1))
            img = np.asarray(scan_render(scene, jnp.asarray(ts)))
        else:
            img = np.asarray(render_fn(spec.animate(scene, t), config))
        ft1 = time.perf_counter()
        dt_est = (ft1 - ft0) / K
        for _ in range(j):
            timer.tick()
            stats.add_frame(w, h, int(scene.lights.count), dt_est, config.shadows)
            frame += 1
            if timer.fps_window_closed:
                if args.watch:
                    print(f"dFPS: {timer.dfps:.1f}  ({stats.primary_rays_per_s/1e6:.1f} M primary rays/s)")
                if bench and bench.record(timer.dfps):
                    print("**BENCHMARK FINISHED**")
                    print(bench.report(), end="")
                    bench.write(args.benchmark_out)
                    done = True
                    break
            if not bench and frame >= n_frames:
                done = True
                break

    print(
        f"frames={stats.frames} avg_ms={1e3*stats.seconds/max(stats.frames,1):.2f} "
        f"primary_rays/s={stats.primary_rays_per_s:.3e} total_rays/s={stats.total_rays_per_s:.3e}"
    )
    if args.screenshot:
        image_io.write_image(args.screenshot, img)
        print(f"screenshot saved: {args.screenshot}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
