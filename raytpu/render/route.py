"""The one routing decision: culled sweep or plain jnp.

Every entry point (``render_image_f32`` here, ``grad.diff_render``, the
sharded renderer and trainer, the CLI, ``bench.py``) asks ``use_sweep``.
It reads ``jax.default_backend()`` while a function is traced, never at
import:

  * ``gpu``: the culled triangle sweep (``raytpu.render.sweep``) serves the
    closest hit and the shadow any-hit of scenes with at least
    ``SWEEP_MIN_TRIS`` triangles; smaller scenes take the jnp path, which
    XLA fuses well when the (rays x primitives) matrices are small;
  * ``cpu``: the jnp path;
  * anything else is an error.

Callers may force the choice with ``sweep=True``/``False``.  On the CPU a
forced sweep needs ``interpret=True`` (tests only): Triton kernels compile
for the GPU alone.
"""

from __future__ import annotations

import functools

import jax

from raytpu.core import math3d
from raytpu.core.types import RenderConfig, Scene
from raytpu.ops import accel
from raytpu.render import renderer, sweep as sweep_mod

#: Triangle count from which the sweep serves a scene on the GPU.  On the
#: H100 (chip_smoke.py phase 2, PERF.md) it beat the dense jnp path end to
#: end on every scene measured, down to the reference scene's 3 triangles;
#: scenes with fewer triangles were not measured and keep the jnp path.
SWEEP_MIN_TRIS = 3

PLATFORMS = ("gpu", "cpu")


def use_sweep(scene: Scene, sweep: bool | None = None) -> bool:
    """True when the culled sweep should serve ``scene``'s closest hit and
    hard-shadow any-hit.  ``sweep`` forces the answer."""
    backend = jax.default_backend()
    if backend not in PLATFORMS:
        raise RuntimeError(
            f"raytpu runs on {' or '.join(PLATFORMS)}, not on JAX backend {backend!r}")
    if sweep is not None:
        return bool(sweep)
    return backend == "gpu" and scene.triangles.count >= SWEEP_MIN_TRIS


def kind(scene: Scene, config: RenderConfig, sweep: bool | None = None) -> str:
    """"sweep" or "jnp": the path ``render_image_f32`` takes for this frame.
    Soft-shadow frames take the jnp path: the soft transmittance has no
    sweep (ROADMAP)."""
    if config.soft_shadows or not use_sweep(scene, sweep):
        return "jnp"
    return "sweep"


def render_sweep_f32(scene: Scene, config: RenderConfig, interpret: bool = False):
    """The forward frame on the culled sweep: winner search with payload,
    all-lights any-hit, and the jnp shade tail, over the whole frame at once
    (every intermediate is O(rays)).  Rays go in 32x32-pixel-block order
    when the resolution allows, so each sweep tile is a compact rectangle."""
    W, H = config.width, config.height
    ro, rd = renderer.generate_rays(scene.camera, config)
    tiled = accel.tile_foldable(H, W)
    if tiled:
        rd = accel.tile_fold(rd, H, W)
    rec = sweep_mod.closest_hit(scene, ro, rd, config.ray_min, interpret)
    any_multi = functools.partial(sweep_mod.any_hit_lights, interpret=interpret)
    colors = renderer.shade_from_records(scene, rec, rd, config, any_multi_fn=any_multi)
    if tiled:
        colors = accel.tile_unfold(colors, H, W)
    return colors.reshape(H, W, 3)


@functools.partial(jax.jit, static_argnames=("config", "sweep", "interpret"))
def render_image_f32(scene: Scene, config: RenderConfig, sweep: bool | None = None,
                     interpret: bool = False):
    """(H, W, 3) float32 tone-mapped image in [0, 1] on the routed path."""
    if kind(scene, config, sweep) == "sweep":
        return render_sweep_f32(scene, config, interpret)
    return renderer.render_image_f32(scene, config)


@functools.partial(jax.jit, static_argnames=("config", "sweep", "interpret"))
def render_image(scene: Scene, config: RenderConfig, sweep: bool | None = None,
                 interpret: bool = False):
    """(H, W, 3) uint8 image on the routed path."""
    return math3d.quantize_u8(render_image_f32(scene, config, sweep, interpret))
