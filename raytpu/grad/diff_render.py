"""Differentiable rendering and inverse-rendering optimization.

The reference renderer is a pure forward program; this module layers
differentiability on top (SURVEY.md §7.4): the f32 forward pass is
differentiable almost everywhere w.r.t. material, light, and geometry
parameters (intersection ops are double-where guarded so VJPs are NaN-free),
and ``soft_shadows`` swaps the binary visibility for a sigmoid transmittance
so shadow boundaries carry gradients too.

``make_train_step`` builds the flagship optimization loop: fit scene
parameters to a target image by gradient descent — the framework's "training
step" (optimizer state is an optax pytree; see raytpu.parallel for the
sharded multi-chip version).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import jax
import jax.numpy as jnp

from raytpu.core.types import RenderConfig, Scene
from raytpu.grad.fast import detached_closest_hit
from raytpu.ops import accel
from raytpu.render import renderer, route, sweep as sweep_mod


def closest_fn_for(scene: Scene, sweep: bool | None = None, interpret: bool = False):
    """The detached closest hit of the fast differentiable path, with its
    winner search on the culled sweep when ``route.use_sweep`` says so
    (also used per shard by the sharded train step,
    raytpu/parallel/training.py).  Returns ``(closest_fn, tiled)``:
    ``tiled`` asks the caller to feed rays in 32x32-pixel-block order."""
    min_t_fn = None
    if route.use_sweep(scene, sweep):
        min_t_fn = functools.partial(sweep_mod.min_t, interpret=interpret)
    closest_fn = functools.partial(detached_closest_hit, min_t_fn=min_t_fn)
    # a detached winner search has O(R) residuals: render_pixels_f32 may
    # hoist it outside the remat checkpoint
    return renderer.mark_detached(closest_fn), min_t_fn is not None


@functools.partial(jax.jit, static_argnames=("config", "detached", "sweep", "interpret"))
def render_soft_f32(scene: Scene, config: RenderConfig, detached: bool = True,
                    sweep: bool | None = None, interpret: bool = False):
    """f32 soft-shadow render on the FAST differentiable path.

      * the shade is rematerialized (``jax.checkpoint``): the backward pass
        recomputes the fused forward instead of saving O(R*N) residuals;
      * ``detached`` (default): closest hits route through
        ``raytpu.grad.fast.detached_closest_hit`` — O(R) differentiated hit
        re-derivation, so the autodiff graph never transposes the O(R*N)
        t-matrix;
      * the detached winner search runs on the culled sweep where
        ``route.use_sweep`` picks it (``sweep`` forces the choice); it is
        forward-only, so gradients are the jnp path's gradients.  The soft
        transmittance is the dense jnp one and its autodiff.
    """
    cfg = dataclasses.replace(config, soft_shadows=True)
    closest_fn, tiled = None, False
    if detached:
        closest_fn, tiled = closest_fn_for(scene, sweep, interpret)
    tiled = tiled and accel.tile_foldable(cfg.height, cfg.width)
    ro, rd = renderer.generate_rays(scene.camera, cfg)
    if tiled:
        rd = accel.tile_fold(rd, cfg.height, cfg.width)
    colors = renderer.render_pixels_f32(scene, ro, rd, cfg, closest_fn=closest_fn, remat=True)
    if tiled:
        colors = accel.tile_unfold(colors, cfg.height, cfg.width)
    return colors.reshape(cfg.height, cfg.width, 3)


def render_soft(scene: Scene, config: RenderConfig, sweep: bool | None = None,
                interpret: bool = False):
    """f32 render with soft (differentiable) shadow visibility."""
    return render_soft_f32(scene, config, sweep=sweep, interpret=interpret)


def image_loss(scene: Scene, target, config: RenderConfig, sweep: bool | None = None,
               interpret: bool = False):
    """Mean squared error against a target f32 image."""
    img = render_soft(scene, config, sweep, interpret)
    return jnp.mean((img - target) ** 2)


def make_train_step(config: RenderConfig, optimizer, param_fn: Callable[[Scene], dict], merge_fn,
                    sweep: bool | None = None, interpret: bool = False):
    """Build a jitted inverse-rendering step.

    Args:
      optimizer: an optax GradientTransformation.
      param_fn: scene -> pytree of the parameters being optimized.
      merge_fn: (scene, params) -> scene with parameters substituted.
      sweep, interpret: the route override of ``render_soft_f32``.
    Returns ``step(params, opt_state, scene, target) -> (params, opt_state, loss)``.
    """

    def loss_fn(params, scene, target):
        return image_loss(merge_fn(scene, params), target, config, sweep, interpret)

    # NOTE: params/opt_state are NOT donated: ``param_fn(scene)`` typically
    # returns views aliasing the scene's own arrays, so donating them would
    # delete the scene's buffers out from under later steps (the params here
    # are KB-scale material/light tables — donation buys nothing).
    @jax.jit
    def step(params, opt_state, scene, target):
        loss, grads = jax.value_and_grad(loss_fn)(params, scene, target)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)
        return params, opt_state, loss

    return step


# -- convenient param selections for inverse rendering ----------------------


def material_params(scene: Scene) -> dict:
    return {"color": scene.materials.color, "params": scene.materials.params}


def merge_material_params(scene: Scene, p: dict) -> Scene:
    mats = dataclasses.replace(scene.materials, color=p["color"], params=p["params"])
    return dataclasses.replace(scene, materials=mats)


def light_params(scene: Scene) -> dict:
    return {
        "position": scene.lights.position,
        "color": scene.lights.color,
        "intensity": scene.lights.intensity,
    }


def merge_light_params(scene: Scene, p: dict) -> Scene:
    lights = dataclasses.replace(
        scene.lights, position=p["position"], color=p["color"], intensity=p["intensity"]
    )
    return dataclasses.replace(scene, lights=lights)


def geometry_params(scene: Scene) -> dict:
    return {
        "sphere_center": scene.spheres.center,
        "sphere_radius": scene.spheres.radius,
        "mesh_positions": scene.meshes.positions,
        "mesh_translation": scene.meshes.translation,
    }


def merge_geometry_params(scene: Scene, p: dict) -> Scene:
    spheres = dataclasses.replace(scene.spheres, center=p["sphere_center"], radius=p["sphere_radius"])
    meshes = dataclasses.replace(scene.meshes, translation=p["mesh_translation"])
    meshes = meshes.with_positions(p["mesh_positions"])  # also refreshes face normals
    scene = dataclasses.replace(scene, spheres=spheres)
    return scene.with_meshes(meshes)
