"""Interactive viewer: the windowed app shell with the reference's controls
(reference: source/main.cpp:23-121).

Key bindings (identical to the reference):
  X   screenshot -> RayTracing_Buffer.bmp (reference: source/main.cpp:70-71)
  F2  toggle shadows                       (reference: source/main.cpp:73-74)
  F3  cycle lighting mode                  (reference: source/main.cpp:76-77)
  F6  start 10-sample FPS benchmark        (reference: source/main.cpp:79-81)
  WASD/arrows + Shift, mouse LMB/RMB       fly camera (reference: source/Camera.h:68-106)
  ESC quit

Uses pygame (SDL) for the window; rendering runs on whatever JAX backend is
active.  Run headless with SDL_VIDEODRIVER=dummy for smoke tests.

Usage: python -m raytpu.app.interactive --scene reference --size 640x480
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np

from raytpu.core import scenes
from raytpu.core.camera import CameraInput, FlyCamera
from raytpu.core.types import LightingMode, RenderConfig
from raytpu.utils.profiling import Benchmark, FrameTimer


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--scene", default="reference", choices=sorted(scenes.REGISTRY))
    p.add_argument("--size", default="640x480")
    p.add_argument("--renderer", default="auto", choices=["auto", "jnp"])
    p.add_argument("--platform", default=None, choices=["cpu", "gpu"])
    p.add_argument("--max-frames", type=int, default=0, help="exit after N frames (0 = run until quit)")
    p.add_argument("--sync", action="store_true",
                   help="fetch each frame before dispatching the next "
                        "(disables the double-buffered dispatch pipeline)")
    args = p.parse_args(argv)
    if args.platform:
        import jax

        jax.config.update("jax_platforms", args.platform)

    import pygame

    from raytpu.app.cli import make_render_fn, sweep_option
    from raytpu.render import route

    w, h = (int(x) for x in args.size.lower().split("x"))
    render_fn = make_render_fn(args.renderer)

    spec = scenes.get(args.scene)
    scene = spec.build()
    fov0 = float(np.arctan(float(scene.camera.fov_scale)) * 2 * 180 / np.pi)
    fly = FlyCamera(origin=tuple(np.asarray(scene.camera.origin).tolist()), fov_degrees=fov0)

    config = RenderConfig(width=w, height=h)
    backend = route.kind(scene, config, sweep_option(args.renderer))
    pygame.init()
    screen = pygame.display.set_mode((w, h))
    pygame.display.set_caption(f"raytpu - {args.scene} [{backend}]")

    timer = FrameTimer()
    bench = Benchmark(10)
    frames = 0
    frame = None  # last displayed frame (None until the first render)
    pending = None  # in-flight dispatched device array (double buffering)
    print(f"raytpu interactive: {args.scene} {w}x{h} backend={backend}")
    running = True
    while running:
        for event in pygame.event.get():
            if event.type == pygame.QUIT:
                running = False
            elif event.type == pygame.KEYDOWN:
                if event.key == pygame.K_ESCAPE:
                    running = False
                elif event.key == pygame.K_x:
                    if frame is None:
                        print("screenshot skipped: no frame rendered yet")
                    else:
                        from raytpu.utils.image import write_bmp

                        write_bmp("RayTracing_Buffer.bmp", frame)
                        print("screenshot saved: RayTracing_Buffer.bmp")
                elif event.key == pygame.K_F2:
                    config = dataclasses.replace(config, shadows=not config.shadows)
                    print(f"shadows: {config.shadows}")
                elif event.key == pygame.K_F3:
                    config = dataclasses.replace(
                        config,
                        lighting_mode=LightingMode((int(config.lighting_mode) + 1) % 4),
                    )
                    print(f"lighting mode: {config.lighting_mode.name}")
                elif event.key == pygame.K_F6:
                    print("**BENCHMARK STARTED**")
                    bench.start()

        keys = pygame.key.get_pressed()
        mouse_dx, mouse_dy = pygame.mouse.get_rel()
        buttons = pygame.mouse.get_pressed()
        inp = CameraInput(
            forward=keys[pygame.K_w] or keys[pygame.K_UP],
            backward=keys[pygame.K_s] or keys[pygame.K_DOWN],
            right=keys[pygame.K_d] or keys[pygame.K_RIGHT],
            left=keys[pygame.K_a] or keys[pygame.K_LEFT],
            shift=keys[pygame.K_LSHIFT] or keys[pygame.K_RSHIFT],
            mouse_dx=mouse_dx,
            mouse_dy=mouse_dy,
            lmb=buttons[0],
            rmb=buttons[2],
        )
        fly = fly.update(inp, timer.elapsed)

        t = timer.total
        s = spec.animate(scene, t).with_camera(fly.camera())
        # double-buffered dispatch: enqueue frame N+1 (JAX dispatch is async)
        # BEFORE fetching frame N, so device execution and the per-dispatch
        # host latency overlap with input handling + display of the
        # previous frame (costs one frame of input latency; --sync disables)
        dispatched = render_fn(s, config)
        if args.sync:
            frame = np.asarray(dispatched)
        else:
            # first iteration has nothing in flight: display this frame (it
            # shows once more next iteration while the pipeline fills)
            frame = np.asarray(pending if pending is not None else dispatched)
            pending = dispatched
        surf = pygame.surfarray.make_surface(frame.transpose(1, 0, 2))
        screen.blit(surf, (0, 0))
        pygame.display.flip()

        timer.tick()
        frames += 1
        if timer.fps_window_closed:
            print(f"dFPS: {timer.dfps:.1f}")
            if bench.record(timer.dfps):
                print("**BENCHMARK FINISHED**")
                print(bench.report(), end="")
                bench.write("benchmark.txt")
        if args.max_frames and frames >= args.max_frames:
            running = False

    pygame.quit()
    return 0


if __name__ == "__main__":
    sys.exit(main())
