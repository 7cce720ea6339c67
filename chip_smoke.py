"""Smoke test of raytpu on one GPU: the main path, end to end, at full size.

Run from the repository root on a machine with an NVIDIA GPU:

    python chip_smoke.py            # phases 0-3 on one card
    python chip_smoke.py --multi    # only the four-card phase (needs 4 cards)

One process drives the card; the CLI is called in this process
(``raytpu.app.cli.main``), never as a second JAX process.  Every check that
fails exits non-zero; nothing is caught.  The last line of standard output
is one JSON object: ``{"ok": true, "device": {"platform", "kind", "count"}}``.

Phases
  0  the device: JAX must see a GPU; prints the card's name and power limit,
     the JAX version and the compile-cache directory.
  1  the 640x480 reference scene through the router and through the CLI's
     --screenshot, both against tests/golden/reference_640x480.png; compile
     seconds and ms/frame over a lax.scan of frames, routed, and on the jnp
     path with its default ray chunking and with one chunk.
  2  reference, bunny, optional and bunny50k at 640x480: the culled sweep
     against the dense jnp path on the same card — t/idx of the primary hits and the u8
     frames within the stated budgets — and both paths' ms/frame (the
     measurement behind route.SWEEP_MIN_TRIS).
  3  three optax-adam inverse-rendering steps on bunny at 640x480 with soft
     shadows, for material and for geometry parameters: finite falling loss,
     gradients on the routed path against the all-jnp path at HIGHEST
     matmul precision, fwd+bwd ms.
  --multi  a 2x2 (px x prim) sharded render of optional against the
     one-card render, and a px=4 sharded train step against the one-card
     step.

Every timing line carries the card's name and power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import statistics
import sys
import tempfile
import time

import numpy as np

#: Fraction of primary rays whose winning primitive may differ between the
#: sweep and the dense path: both run the same f32 formulas, but the two
#: compilers contract FMAs differently, which can flip a hit that sits on a
#: triangle edge or a t tie.
IDX_FLIP_BUDGET = 1e-3
#: Relative tolerance of t where both paths pick the same winner (a few f32
#: ulps of FMA contraction, with headroom).
T_RTOL = 1e-4
#: Gradient agreement, routed path against all-jnp: relative L2 error per
#: parameter leaf.  Identical winners give the same gradient formulas, summed
#: in another order by differently fused programs; the budget also covers the
#: boundary pixels whose winner may flip (IDX_FLIP_BUDGET).
GRAD_RTOL = 1e-3

#: Phase 2's scenes, smallest first: the reference scene (3 triangles) and
#: the three meshes bracket the sweep's break-even triangle count.
MESH_SCENES = ("reference", "bunny", "optional", "bunny50k")

def check(ok, what: str):
    """Fail the smoke test (exit non-zero) unless ``ok``."""
    if not ok:
        raise SystemExit(f"chip_smoke FAILED: {what}")
    print(f"  ok: {what}")


@functools.cache
def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    from raytpu.utils import device

    return device.card_name_and_power_limit()


def timing(what: str):
    print(f"  {what}  [{card().replace(chr(10), '; ')}]")


def time_calls(fn, args, per_dispatch: int, repeats: int = 5):
    """Median ms per frame of ``fn(*args)`` over ``repeats`` dispatches of
    ``per_dispatch`` frames, each ended by block_until_ready (one warm-up
    call first)."""
    import jax

    jax.block_until_ready(fn(*args))
    samples = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        samples.append(time.perf_counter() - t0)
    return statistics.median(samples) * 1e3 / per_dispatch


def compile_and_time(fn, args, per_dispatch: int, repeats: int = 5):
    """Compile ``jax.jit(fn)`` for ``args``; returns (compiled, compile s,
    ms per frame as ``time_calls`` measures it)."""
    import jax

    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    compile_s = time.perf_counter() - t0
    return compiled, compile_s, time_calls(compiled, args, per_dispatch, repeats)


def scan_frames(spec, render, frames: int):
    """fn(scene) rendering ``frames`` animated frames in one lax.scan."""
    import jax
    import jax.numpy as jnp

    def run(scene):
        def body(carry, t):
            return carry + jnp.sum(render(spec.animate(scene, t))), None

        ts = jnp.linspace(0.0, 2.0 * np.pi, frames)
        return jax.lax.scan(body, jnp.float32(0.0), ts)[0]

    return run


def dense_min_t(scene, ro, rd, tmin):
    """(t, idx) of the dense jnp winner search, chunked over rays so the
    (primitives x rays) t-matrix stays under 2^25 elements."""
    import jax
    import jax.numpy as jnp

    from raytpu.ops import intersect, soa

    R = rd.shape[0]
    chunk = max(256, min(R, (1 << 25) // max(scene.num_primitives, 1)) // 256 * 256)
    pad = (-R) % chunk
    ro_p = jnp.pad(ro, ((0, pad), (0, 0))).reshape(-1, chunk, 3)
    rd_p = jnp.pad(rd, ((0, pad), (0, 0))).reshape(-1, chunk, 3)

    def body(args):
        tm = intersect._scene_t_matrix_T(scene, soa.comps(args[0]), soa.comps(args[1]),
                                         tmin, jnp.inf, shadow_pass=False)
        return jnp.min(tm, axis=0), jnp.argmin(tm, axis=0).astype(jnp.int32)

    t, idx = jax.lax.map(body, (ro_p, rd_p))
    return t.reshape(-1)[:R], idx.reshape(-1)[:R]


def compare_hits(scene, config, interpret: bool = False):
    """Sweep against dense winner search on the primary rays (in the
    sweep's tile order); returns (idx mismatch fraction, worst relative t
    error over matching winners)."""
    import jax
    import jax.numpy as jnp

    from raytpu.ops import accel
    from raytpu.render import renderer, sweep

    ro, rd = renderer.generate_rays(scene.camera, config)
    if accel.tile_foldable(config.height, config.width):
        rd = accel.tile_fold(rd, config.height, config.width)
    ro_b = jnp.broadcast_to(ro, rd.shape)
    tmin = config.ray_min
    t_s, i_s = jax.jit(lambda s, a, b: sweep.min_t(s, a, b, tmin, interpret))(scene, ro_b, rd)
    t_d, i_d = jax.jit(lambda s, a, b: dense_min_t(s, a, b, tmin))(scene, ro_b, rd)
    t_s, i_s, t_d, i_d = map(np.asarray, (t_s, i_s, t_d, i_d))
    hit = np.isfinite(t_d)
    same = (i_s == i_d) & (np.isfinite(t_s) == hit)
    rel = np.abs(t_s - t_d) / np.maximum(1.0, np.abs(t_d))
    worst = float(np.max(rel[same & hit], initial=0.0))
    return float(1.0 - same.mean()), worst


def phase_device():
    import jax

    from raytpu.utils import compile_cache, device

    desc = device.describe()
    print("phase 0: device")
    check(desc["platform"] == "gpu", f"JAX's default device is a GPU ({desc})")
    print(card())
    from raytpu.native import runtime

    print(f"  jax {jax.__version__}; compile cache: {compile_cache.enable()}; "
          f"native SAH builder: {runtime.available()}")
    return desc


def phase_reference(size=(640, 480), frames: int = 16, cli: bool = True):
    """The reference scene against its golden, through the router and the
    CLI; timings for the default ray chunking and one chunk."""
    import jax

    from raytpu.core import scenes
    from raytpu.core.types import RenderConfig
    from raytpu.render import route
    from raytpu.utils.image import FLIP_BUDGET, MEAN_DIFF_BUDGET, flip_stats, read_bmp, read_png

    print(f"phase 1: reference scene {size[0]}x{size[1]}")
    golden = read_png(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                   "tests", "golden", "reference_640x480.png"))
    spec = scenes.get("reference")
    scene = spec.build()
    cfg = RenderConfig(width=size[0], height=size[1])
    img = np.asarray(route.render_image(scene, cfg))
    print(f"  route: {route.kind(scene, cfg)}")
    if size == (640, 480):
        flipped, mean_diff = flip_stats(img, golden)
        check(flipped <= FLIP_BUDGET and mean_diff <= MEAN_DIFF_BUDGET,
              f"router frame vs golden: {flipped:.5f} of pixels flipped (budget "
              f"{FLIP_BUDGET}), mean diff {mean_diff:.4f}")
    if cli:
        from raytpu.app import cli

        with tempfile.TemporaryDirectory() as tmp:
            shot = os.path.join(tmp, "reference.bmp")
            rc = cli.main(["--scene", "reference", "--size", f"{size[0]}x{size[1]}",
                           "--screenshot", shot])
            check(rc == 0, "cli.main --screenshot exited 0")
            shot_img = read_bmp(shot)
        flipped, mean_diff = flip_stats(shot_img, img)
        check(shot_img.shape == img.shape and flipped == 0.0,
              "CLI screenshot equals the router frame")
    # the routed frame, then the jnp path's ray chunking against one chunk
    for label, c, sweep in (("routed", cfg, None), ("jnp, default chunks", cfg, False),
                            ("jnp, one chunk",
                             dataclasses.replace(cfg, ray_chunk=cfg.width * cfg.height), False)):
        run = scan_frames(spec, lambda s, c=c, sw=sweep: route.render_image_f32(s, c, sw), frames)
        _, compile_s, ms = compile_and_time(run, (scene,), frames)
        timing(f"reference {label}: compile {compile_s:.2f} s, {ms:.4f} ms/frame "
               f"over {frames} frames per dispatch")
    jax.clear_caches()


def phase_mesh(names=MESH_SCENES, size=(640, 480), interpret: bool = False,
               frames: dict | None = None):
    """Sweep against dense jnp per mesh scene: correctness and ms/frame."""
    import jax

    from raytpu.core import scenes
    from raytpu.core.types import RenderConfig
    from raytpu.render import route
    from raytpu.utils.image import FLIP_BUDGET, MEAN_DIFF_BUDGET, flip_stats

    frames = frames or {"reference": 16, "bunny": 16, "optional": 8, "bunny50k": 2}
    print(f"phase 2: sweep against dense jnp at {size[0]}x{size[1]}")
    cfg = RenderConfig(width=size[0], height=size[1])
    results = {}
    for name in names:
        spec = scenes.get(name)
        scene = spec.build()
        T = scene.triangles.count
        flips, worst = compare_hits(scene, cfg, interpret)
        check(flips <= IDX_FLIP_BUDGET and worst <= T_RTOL,
              f"{name} ({T} tris): sweep winner differs on {flips:.6f} of primary rays "
              f"(budget {IDX_FLIP_BUDGET}); worst t rel err {worst:.2e} (tol {T_RTOL})")
        img_s = np.asarray(route.render_image(scene, cfg, sweep=True, interpret=interpret))
        img_d = np.asarray(route.render_image(scene, cfg, sweep=False))
        flipped, mean_diff = flip_stats(img_s, img_d)
        check(flipped <= FLIP_BUDGET and mean_diff <= MEAN_DIFF_BUDGET,
              f"{name}: sweep frame vs dense frame: {flipped:.5f} flipped, "
              f"mean diff {mean_diff:.4f}")
        k = frames.get(name, 2)
        ms = {}
        for route_name, sweep in (("sweep", True), ("dense", False)):
            run = scan_frames(spec, lambda s, sw=sweep: route.render_image_f32(
                s, cfg, sweep=sw, interpret=interpret), k)
            compiled, compile_s, ms[route_name] = compile_and_time(run, (scene,), k)
            timing(f"{name} ({T} tris) {route_name}: compile {compile_s:.2f} s, "
                   f"{ms[route_name]:.3f} ms/frame over {k} frames per dispatch")
            if name == names[-1]:
                print(f"  {name} {route_name} memory_analysis: {compiled.memory_analysis()}")
        results[name] = ms
        jax.clear_caches()
    faster = [n for n in names if results[n]["sweep"] < results[n]["dense"]]
    print(f"  sweep faster than dense on: {faster or 'none'}; route.SWEEP_MIN_TRIS = "
          f"{route.SWEEP_MIN_TRIS}")
    return results


def _fit(name, size, param_fn, merge_fn, perturb, lr, sweep, interpret, steps=3):
    """Three adam steps from perturbed parameters towards the true frame;
    returns (losses, routed grads, all-jnp grads, fwd+bwd ms)."""
    import jax
    import jax.numpy as jnp
    import optax

    from raytpu.core import scenes
    from raytpu.core.types import RenderConfig
    from raytpu.grad import diff_render

    cfg = RenderConfig(width=size[0], height=size[1], soft_shadows=True, soft_beta=60.0)
    truth = scenes.get(name).build()
    target = diff_render.render_soft(truth, cfg, sweep, interpret)
    start = merge_fn(truth, perturb(param_fn(truth)))
    params = param_fn(start)
    opt = optax.adam(lr)
    steps_fn = {label: diff_render.make_train_step(cfg, opt, param_fn, merge_fn, sw, interpret)
                for label, sw in (("routed", sweep), ("all-jnp", False))}
    p0, s0 = param_fn(start), opt.init(param_fn(start))
    opt_state = s0
    losses = []
    for _ in range(steps):
        params, opt_state, loss = steps_fn["routed"](params, opt_state, start, target)
        losses.append(float(loss))

    def grads(sweep):
        def loss_fn(p):
            img = diff_render.render_soft_f32(merge_fn(start, p), cfg, sweep=sweep,
                                              interpret=interpret)
            return jnp.mean((img - target) ** 2)

        with jax.default_matmul_precision("highest"):
            return jax.jit(jax.grad(loss_fn))(param_fn(start))

    g_route, g_jnp = grads(sweep), grads(False)
    ms = {label: time_calls(st, (p0, s0, start, target), 1) for label, st in steps_fn.items()}
    return losses, g_route, g_jnp, ms


def phase_inverse(size=(640, 480), sweep=None, interpret: bool = False):
    import jax
    import jax.numpy as jnp

    from raytpu.core import scenes
    from raytpu.grad import diff_render
    from raytpu.render import route

    path = "sweep" if route.use_sweep(scenes.get("bunny").build(), sweep) else "jnp"
    print(f"phase 3: inverse rendering, bunny {size[0]}x{size[1]}, soft shadows, "
          f"closest hit on {path}")
    fits = {
        "material": (diff_render.material_params, diff_render.merge_material_params,
                     lambda p: {**p, "color": jnp.clip(p["color"] * 0.6 + 0.2, 0.0, 1.0)},
                     5e-2),
        "geometry": (diff_render.geometry_params, diff_render.merge_geometry_params,
                     lambda p: {**p, "mesh_translation":
                                p["mesh_translation"] + jnp.array([0.08, 0.0, 0.0])},
                     1e-2),
    }
    for kind, (param_fn, merge_fn, perturb, lr) in fits.items():
        losses, g_route, g_jnp, ms = _fit("bunny", size, param_fn, merge_fn, perturb, lr,
                                          sweep, interpret)
        check(all(np.isfinite(losses)) and losses[-1] < losses[0],
              f"{kind} fit: loss finite and falling {losses}")
        errs = {}
        for (key, a), b in zip(jax.tree_util.tree_leaves_with_path(g_route),
                               jax.tree_util.tree_leaves(g_jnp)):
            a, b = np.asarray(a), np.asarray(b)
            if b.size:
                errs[jax.tree_util.keystr(key)] = float(
                    np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))
        check(all(np.isfinite(list(errs.values()))) and max(errs.values()) <= GRAD_RTOL,
              f"{kind} grads on {path} vs all-jnp: relative L2 errors {errs} "
              f"(tol {GRAD_RTOL})")
        timing(f"bunny {kind} fwd+bwd step: {ms['routed']:.3f} ms routed ({path}), "
               f"{ms['all-jnp']:.3f} ms all-jnp")
        jax.clear_caches()


def phase_multi(devices, size=(640, 480), train_size=(640, 480), sweep=None,
                interpret: bool = False):
    """2x2 sharded render of optional and px=4 sharded train step, each
    against its one-card counterpart on ``devices[0]``."""
    import jax
    import jax.numpy as jnp
    import optax

    from raytpu.core import scenes
    from raytpu.core.types import RenderConfig
    from raytpu.grad import diff_render
    from raytpu.parallel import make_mesh, render_image_sharded
    from raytpu.parallel.training import make_sharded_train_step
    from raytpu.render import route
    from raytpu.utils.image import FLIP_BUDGET, flip_stats

    print(f"multi: {len(devices)} devices")
    check(len(devices) == 4, "four devices")
    scene = scenes.get("optional").build()
    cfg = RenderConfig(width=size[0], height=size[1])
    one = np.asarray(route.render_image(scene, cfg, sweep, interpret))
    mesh = make_mesh(px=2, prim=2, devices=devices)
    four = np.asarray(render_image_sharded(scene, cfg, mesh, sweep, interpret))
    flipped, _ = flip_stats(four, one)
    check(flipped <= FLIP_BUDGET,
          f"2x2 sharded optional vs one card: {np.mean(four == one):.6f} of channels "
          f"bit-identical, {flipped:.6f} of pixels flipped (budget {FLIP_BUDGET})")
    ms_one = time_calls(lambda: route.render_image(scene, cfg, sweep, interpret), (), 1)
    ms_four = time_calls(lambda: render_image_sharded(scene, cfg, mesh, sweep, interpret), (), 1)
    timing(f"optional {size[0]}x{size[1]} ({route.kind(scene, cfg, sweep)}): "
           f"{ms_one:.3f} ms/frame on one card, {ms_four:.3f} ms/frame on the 2x2 mesh, "
           f"one frame per dispatch")

    bunny = scenes.get("bunny").build()
    tcfg = RenderConfig(width=train_size[0], height=train_size[1])
    target = jnp.zeros((tcfg.height, tcfg.width, 3), jnp.float32)
    opt = optax.sgd(1e-2)
    p0 = diff_render.material_params(bunny)
    copy = lambda: jax.tree_util.tree_map(jnp.copy, p0)
    step1 = diff_render.make_train_step(tcfg, opt, diff_render.material_params,
                                        diff_render.merge_material_params,
                                        sweep, interpret)
    p1, _, loss1 = step1(copy(), opt.init(p0), bunny, target)
    step4 = make_sharded_train_step(tcfg, opt, diff_render.material_params,
                                    diff_render.merge_material_params,
                                    make_mesh(px=4, prim=1, devices=devices),
                                    sweep, interpret)
    p4, _, loss4 = step4(copy(), opt.init(p0), bunny, target)
    check(np.allclose(float(loss1), float(loss4), rtol=1e-5),
          f"px=4 train step loss {float(loss4)} vs one card {float(loss1)} (rtol 1e-5)")
    for a, b in zip(jax.tree_util.tree_leaves(p1), jax.tree_util.tree_leaves(p4)):
        check(np.allclose(np.asarray(a), np.asarray(b), rtol=1e-4, atol=1e-6),
              "px=4 train step params match one card (rtol 1e-4)")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--multi", action="store_true",
                   help="run only the four-card phase (sharded render and train step)")
    args = p.parse_args(argv)

    import jax

    desc = phase_device()
    if args.multi:
        phase_multi(jax.devices()[:4])
    else:
        phase_reference()
        phase_mesh()
        phase_inverse()
    print(card())
    print(json.dumps({"ok": True, "device": desc}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
