"""Sharded inverse-rendering training: the framework's distributed train step.

Pixels (the 'batch' axis) are sharded over the ``px`` mesh axis; scene
parameters are replicated.  The per-shard loss gradient is all-reduced with
``psum`` — emitted inside the backward pass so XLA overlaps the gradient
all-reduce with remaining backward compute (XLA's async collectives handle
the scheduling).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from raytpu.core.types import RenderConfig, Scene
from raytpu.ops import accel
from raytpu.render.renderer import generate_rays


def make_sharded_train_step(config: RenderConfig, optimizer, param_fn, merge_fn, mesh: Mesh,
                            sweep: bool | None = None, interpret: bool = False):
    """Build a jitted multi-device train step.

    Same contract as raytpu.grad.make_train_step but with the ray grid sharded
    over ``mesh`` axis 'px' and gradients psum-reduced across shards.
    ``sweep``/``interpret`` are the route override of ``render_soft_f32``.

    Returns ``step(params, opt_state, scene, target) -> (params, opt_state, loss)``
    where ``target`` is the (H, W, 3) f32 target image.
    """
    soft_cfg = dataclasses.replace(config, soft_shadows=True)
    n_px = mesh.shape["px"]

    def loss_and_grad_local(params, scene, rd_block, target_block, num_rays):
        """Per-shard loss/grad on this device's ray block (runs inside shard_map)."""

        block = rd_block.shape[0]
        base = jax.lax.axis_index("px") * block
        lane = base + jnp.arange(block)
        valid = (lane < num_rays)[:, None]  # mask out padded rays

        def local_loss(p):
            from raytpu.grad import diff_render
            from raytpu.render.renderer import render_pixels_f32

            s = merge_fn(scene, p)
            ro, _ = generate_rays(s.camera, soft_cfg)
            # same fast path as the single-device step: detached closest hit
            # (on the culled sweep where the route picks it) and remat
            closest_fn, _ = diff_render.closest_fn_for(s, sweep, interpret)
            colors = render_pixels_f32(
                s, ro, rd_block, soft_cfg, closest_fn=closest_fn, remat=True)
            err = jnp.sum(jnp.where(valid, (colors - target_block) ** 2, 0.0))
            return err / (num_rays * 3.0)

        loss, grads = jax.value_and_grad(local_loss)(params)
        # gradient all-reduce over the pixel shards; XLA overlaps this with
        # the rest of the backward pass
        grads = jax.lax.psum(grads, "px")
        grads = jax.lax.pmean(grads, "prim") if "prim" in mesh.axis_names else grads
        loss = jax.lax.psum(loss, "px")
        loss = jax.lax.pmean(loss, "prim") if "prim" in mesh.axis_names else loss
        return loss, grads

    # NOT donated: param_fn(scene) aliases the scene's arrays (see
    # raytpu.grad.diff_render.make_train_step)
    @jax.jit
    def step(params, opt_state, scene, target):
        from raytpu.grad import diff_render

        ro, rd = generate_rays(scene.camera, soft_cfg)
        num_rays = rd.shape[0]
        tgt = target.reshape(-1, 3)
        # sweep path: rays (and target rows, same permutation) in
        # 32x32-pixel-block order for tight per-tile cull cones inside each
        # shard (the loss is a masked sum — permutation-invariant)
        _, tiled = diff_render.closest_fn_for(scene, sweep, interpret)
        if tiled and accel.tile_foldable(soft_cfg.height, soft_cfg.width):
            rd = accel.tile_fold(rd, soft_cfg.height, soft_cfg.width)
            tgt = accel.tile_fold(tgt, soft_cfg.height, soft_cfg.width)
        pad = (-num_rays) % n_px
        rd_p = jnp.pad(rd, ((0, pad), (0, 0)), constant_values=1.0)
        tgt_p = jnp.pad(tgt, ((0, pad), (0, 0)))

        params_spec = jax.tree_util.tree_map(lambda _: P(), params)
        scene_spec = jax.tree_util.tree_map(lambda _: P(), scene)

        loss, grads = shard_map(
            functools.partial(loss_and_grad_local, num_rays=num_rays),
            mesh=mesh,
            in_specs=(params_spec, scene_spec, P("px", None), P("px", None)),
            out_specs=(P(), params_spec),
            check_vma=False,
        )(params, scene, rd_p, tgt_p)

        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)
        return params, opt_state, loss

    return step
