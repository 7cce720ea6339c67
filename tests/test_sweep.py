"""The culled sweep's closest hit (raytpu/render/sweep.py) in Pallas
interpret mode against the dense jnp closest hit, over the course scenes.

On the CPU both paths, jitted, run the same f32 formulas through XLA:CPU, so
winners, t and payload match exactly; on the GPU the two compilers may contract FMAs
differently, and chip_smoke.py applies the stated flip budget instead."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytpu.core import scenes
from raytpu.core.types import RenderConfig
from raytpu.ops import intersect, soa
from raytpu.render import renderer, sweep

COURSE_SCENES = ["sphere", "phong", "w1", "w2", "w3_test", "w3", "w4_test",
                 "reference", "bunny", "optional"]
CFG = RenderConfig(width=64, height=48)


def _rays(scene, cfg=CFG):
    ro, rd = renderer.generate_rays(scene.camera, cfg)
    return jnp.broadcast_to(ro, rd.shape), rd


@pytest.mark.parametrize("name", COURSE_SCENES)
def test_closest_hit_payload_matches_jnp(name):
    """Payload on: the records built from the kernel's payload registers
    equal intersect.closest_hit's one-hot-gathered records."""
    scene = scenes.get(name).build()
    ro, rd = _rays(scene)
    got = jax.jit(lambda s, a, b: sweep.closest_hit(s, a, b, CFG.ray_min, interpret=True))(
        scene, ro, rd)
    ref = jax.jit(lambda s, a, b: intersect.closest_hit(s, a, b, CFG.ray_min))(scene, ro, rd)
    for field in ("hit", "t", "point", "normal", "material"):
        np.testing.assert_array_equal(np.asarray(getattr(got, field)),
                                      np.asarray(getattr(ref, field)), err_msg=field)


@pytest.mark.parametrize("name", COURSE_SCENES)
def test_min_t_matches_jnp_argmin(name):
    """Payload off: (t, idx) equal the dense t-matrix's min and first argmin
    (the reference's iteration-order tie-break)."""
    scene = scenes.get(name).build()
    ro, rd = _rays(scene)
    t, idx = jax.jit(lambda s, a, b: sweep.min_t(s, a, b, CFG.ray_min, interpret=True))(
        scene, ro, rd)

    @jax.jit
    def dense(s, a, b):
        tm = intersect._scene_t_matrix_T(s, soa.comps(a), soa.comps(b), CFG.ray_min,
                                         jnp.inf, shadow_pass=False)
        return jnp.min(tm, axis=0), jnp.argmin(tm, axis=0)

    t_ref, idx_ref = dense(scene, ro, rd)
    np.testing.assert_array_equal(np.asarray(t), np.asarray(t_ref))
    hit = np.isfinite(np.asarray(t))
    np.testing.assert_array_equal(np.asarray(idx)[hit], np.asarray(idx_ref)[hit])
    assert (np.asarray(idx)[~hit] == 0).all()
