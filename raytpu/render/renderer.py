"""The jitted forward renderer: raygen -> closest hit -> shadow + shading -> tonemap.

Replaces ``Renderer::Render`` / ``RenderPixel`` (reference:
source/Renderer.cpp:34-182).  The per-pixel loop becomes batched array ops
over the whole ray grid; the per-core pixel fan-out (reference:
source/Renderer.cpp:42-92) becomes XLA vectorization on the device plus
``raytpu.parallel`` sharding across devices.

This is the plain jnp path: every ray against every primitive, with rays
processed in chunks (``lax.map``) sized so the (rays x primitives)
intermediates stay bounded in device memory.  It is the reference the
culled sweep (``raytpu.render.sweep``) is tested against; which of the two
a frame takes is decided in ``raytpu.render.route``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from raytpu.core import math3d
from raytpu.core.types import LightingMode, RenderConfig, Scene
from raytpu.ops import intersect, shading, soa


def generate_rays(camera, config: RenderConfig):
    """Primary ray directions for the pixel grid.

    NDC mapping (reference: source/Renderer.cpp:104-114):
      cx = (2(px+.5)/W - 1) * aspect * fov,  cy = (1 - 2(py+.5)/H) * fov
      dir = normalize(cx*right + cy*up + forward)

    Returns ``(origin (3,), directions (H*W, 3))`` in row-major pixel order.
    """
    W, H = config.width, config.height
    right, up, fwd = camera.onb()
    px = (jnp.arange(W, dtype=jnp.float32) + 0.5) / W
    py = (jnp.arange(H, dtype=jnp.float32) + 0.5) / H
    cx = (2.0 * px - 1.0) * jnp.float32(config.aspect_ratio) * camera.fov_scale  # (W,)
    cy = (1.0 - 2.0 * py) * camera.fov_scale  # (H,)
    d = (
        cx[None, :, None] * right[None, None, :]
        + cy[:, None, None] * up[None, None, :]
        + fwd[None, None, :]
    )  # (H,W,3)
    d = math3d.normalize(d)
    return camera.origin, d.reshape(-1, 3)


def shade_rays(scene: Scene, ro, rd, config: RenderConfig, closest_fn=None, any_fn=None,
               any_multi_fn=None):
    """Full per-ray pipeline for a batch of rays: closest hit, per-light shadow
    + lighting-mode shading, shadow dimming, tone map.  Returns (N,3) f32 in
    [0,1] (pre-quantization).  ``ro`` is (3,) or (N,3).

    ``closest_fn``/``any_fn`` select the intersection implementation
    (default: the batched jnp ops).  ``any_multi_fn(scene, p_off, dirs
    (L,R,3), mags (L,R), tmin) -> (L,R)`` computes every light's occlusion
    in one pass when provided (the culled sweep's any-hit).
    """
    closest_fn = closest_fn or intersect.closest_hit
    ro = jnp.broadcast_to(ro, rd.shape)
    rec = closest_fn(scene, ro, rd, config.ray_min)
    return shade_from_records(scene, rec, rd, config, any_fn=any_fn,
                              any_multi_fn=any_multi_fn)


def shadow_query_inputs(scene: Scene, rec, config: RenderConfig):
    """(p_off (R,3), dirs (L,R,3), mags (L,R)) for the per-light occlusion
    queries of ``shade_from_records``."""
    n_c = soa.comps(rec.normal)
    p_off = soa.pack(
        *soa.add(soa.comps(rec.point), soa.scale(n_c, jnp.float32(config.normal_offset)))
    )
    lds = [shading.direction_to_light(scene.lights, li, p_off)
           for li in range(scene.lights.count)]
    if not lds:
        return p_off, None, None
    return p_off, jnp.stack([l for l, _ in lds]), jnp.stack([m for _, m in lds])


def shade_from_records(scene: Scene, rec, rd, config: RenderConfig,
                       any_fn=None, any_multi_fn=None):
    """The shading tail of ``shade_rays`` given precomputed hit records —
    split out so the differentiable path can place its remat boundary here
    (the closest hit's records are cheap residuals; recomputing the winner
    search + payload assembly in every backward is not)."""
    any_fn = any_fn or intersect.any_hit
    n = rd.shape[0]

    n_c = soa.comps(rec.normal)
    p_off, dirs_all, mags_all = shadow_query_inputs(scene, rec, config)

    color = (jnp.zeros((n,), jnp.float32),) * 3
    shadow_factor = jnp.ones((n,), jnp.float32)
    mode = config.lighting_mode

    occ_multi = None
    if (any_multi_fn is not None and config.shadows and not config.soft_shadows
            and dirs_all is not None):
        occ_multi = any_multi_fn(scene, p_off, dirs_all, mags_all, config.ray_min)

    for li in range(scene.lights.count):
        l, mag = dirs_all[li], mags_all[li]
        if config.shadows and config.soft_shadows:
            # differentiable transmittance in [0,1]; hard limit as beta->inf
            trans = intersect.soft_transmittance(
                scene, p_off, l, jnp.float32(config.ray_min), mag, jnp.float32(config.soft_beta)
            )
            trans = jnp.where(rec.hit, trans, 1.0)
        elif config.shadows:
            occluded = occ_multi[li] if occ_multi is not None else any_fn(scene, p_off, l, config.ray_min, mag)
            trans = jnp.where(occluded & rec.hit, 0.0, 1.0)
        else:
            trans = jnp.ones((n,), jnp.float32)
        # each occluded light dims the whole pixel (reference: source/Renderer.cpp:139);
        # the soft form interpolates: factor = dim + (1-dim)*transmittance
        if config.shadows and config.soft_shadows:
            factor = jnp.float32(config.shadow_dim) + (1.0 - jnp.float32(config.shadow_dim)) * trans
        else:
            # exact 1.0/dim factors preserve bit-parity with the reference
            factor = jnp.where(trans == 0.0, jnp.float32(config.shadow_dim), 1.0)
        shadow_factor = shadow_factor * factor

        l_c = soa.comps(l)
        if mode == LightingMode.COMBINED:
            oa = jnp.maximum(soa.dot(n_c, l_c), 0.0)
            rad = soa.comps(shading.radiance(scene.lights, li, rec.point))
            brdf = soa.comps(shading.shade(scene.materials, rec.material, rec.normal, l, -rd))
            contrib = tuple(oa * rad[i] * brdf[i] for i in range(3))
        elif mode == LightingMode.OBSERVED_AREA:
            oa = jnp.maximum(soa.dot(n_c, l_c), 0.0)
            contrib = (oa, oa, oa)
        elif mode == LightingMode.RADIANCE:
            contrib = soa.comps(shading.radiance(scene.lights, li, rec.point))
        else:  # BRDF
            contrib = soa.comps(shading.shade(scene.materials, rec.material, rec.normal, l, -rd))
        color = tuple(color[i] + contrib[i] * trans for i in range(3))

    color = tuple(jnp.where(rec.hit, color[i] * shadow_factor, 0.0) for i in range(3))
    # max_to_one tone map (reference: source/ColorRGB.h:12-17), double-where'd
    m = jnp.maximum(jnp.maximum(color[0], color[1]), color[2])
    over = m > 1.0
    m_safe = jnp.where(over, m, 1.0)
    color = tuple(jnp.where(over, color[i] / m_safe, color[i]) for i in range(3))
    return soa.pack(*color)


def mark_detached(fn):
    """Tag a ``closest_fn`` whose residuals are O(R) — a detached winner
    search whose backward never transposes the O(R*C) t-matrix.  Only such
    overrides may be hoisted outside the remat checkpoint in
    ``render_pixels_f32``; unmarked overrides stay inside the full-body
    checkpoint (an unmarked dense closest_fn would silently reintroduce the
    residual blowup remat exists to fix)."""

    def wrapped(*args, **kwargs):
        return fn(*args, **kwargs)

    wrapped.detached_residuals = True
    return wrapped


def _auto_chunk(num_rays: int, num_prims: int) -> int:
    """Ray-chunk size keeping the (rays x prims) t-matrix ~<=32M elements.

    Chunks are balanced (ceil-div) and 1024-aligned so the final chunk is
    nearly full: a power-of-two chunk on 640x480 (307,200 rays) padded to
    2x262,144 — 71% wasted work.  Chunks are also capped at 75k rays even
    when the t-matrix would fit: on the H100 the 640x480 reference scene
    renders in 4x76,800-ray chunks 8% faster than in one 307,200-ray chunk
    (chip_smoke.py phase 1, PERF.md).
    """
    target = max(1024, min(75 * 1024, (1 << 25) // max(num_prims, 1)))
    if num_rays <= target:
        return max(num_rays, 1)
    n_chunks = -(-num_rays // target)
    return 1024 * (-(-num_rays // (n_chunks * 1024)))


def render_pixels_f32(scene: Scene, ro, rd, config: RenderConfig, closest_fn=None,
                      remat: bool = False):
    """Chunked shade_rays over an arbitrary flat ray batch.

    ``remat``: wrap the shade in ``jax.checkpoint`` so a backward pass
    recomputes the forward instead of saving its O(rays x primitives)
    residuals in HBM.
    """
    n = rd.shape[0]
    nprim = max(scene.num_primitives, 1)
    chunk = config.ray_chunk or _auto_chunk(n, nprim)
    if (remat and closest_fn is not None
            and getattr(closest_fn, "detached_residuals", False)):
        # remat boundary AFTER the closest hit: the hit records (~11
        # floats/ray) are cheap residuals, so the backward recomputes only
        # the shade tail (soft transmittance included) — not the winner
        # search and payload assembly.  Only valid for ``mark_detached``
        # overrides (O(R) residuals): a dense differentiable closest_fn must
        # stay INSIDE the checkpoint or its O(R*C) t-matrix residuals get
        # saved for the transpose — the exact blowup remat exists to fix.
        shade_ckpt = jax.checkpoint(
            lambda s, rec, rds: shade_from_records(s, rec, rds, config))

        def body(s, rds):
            rec = closest_fn(s, jnp.broadcast_to(ro, rds.shape), rds, config.ray_min)
            return shade_ckpt(s, rec, rds)
    elif remat:
        body = jax.checkpoint(
            lambda s, rds: shade_rays(s, ro, rds, config, closest_fn=closest_fn))
    else:
        body = lambda s, rds: shade_rays(s, ro, rds, config, closest_fn=closest_fn)
    if n <= chunk:
        return body(scene, rd)
    pad = (-n) % chunk
    # edge-replicate: padded rays duplicate a real ray, so the padded lanes
    # can't introduce gradients/partials that real rays don't have
    rd_p = jnp.pad(rd, ((0, pad), (0, 0)), mode="edge").reshape(-1, chunk, 3)
    out = jax.lax.map(lambda rds: body(scene, rds), rd_p).reshape(-1, 3)
    return out[:n]


@functools.partial(jax.jit, static_argnames=("config",))
def render_image_f32(scene: Scene, config: RenderConfig):
    """(H, W, 3) float32 tone-mapped image in [0,1]."""
    ro, rd = generate_rays(scene.camera, config)
    colors = render_pixels_f32(scene, ro, rd, config)
    return colors.reshape(config.height, config.width, 3)


@functools.partial(jax.jit, static_argnames=("config",))
def render_image(scene: Scene, config: RenderConfig):
    """(H, W, 3) uint8 image — truncating quantization like the reference's
    ``static_cast<uint8_t>(c*255)`` (reference: source/Renderer.cpp:178-181)."""
    return math3d.quantize_u8(render_image_f32(scene, config))


@functools.partial(jax.jit, static_argnames=("config", "samples", "render_fn"))
def render_image_ssaa(scene: Scene, config: RenderConfig, samples: int = 2, render_fn=None):
    """Supersampled render: trace a ``samples x samples`` grid per pixel and
    box-filter (a capability the reference lacks — it traces one center ray,
    reference: source/Renderer.cpp:104-108).  Works with any backend's
    ``render_image_f32`` via ``render_fn``.  Returns (H, W, 3) uint8."""
    import dataclasses

    render_fn = render_fn or render_image_f32
    hi = dataclasses.replace(
        config, width=config.width * samples, height=config.height * samples
    )
    img = render_fn(scene, hi)
    img = img.reshape(config.height, samples, config.width, samples, 3).mean(axis=(1, 3))
    return math3d.quantize_u8(img)
