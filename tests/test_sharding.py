"""Multi-device tests on the virtual 8-device CPU mesh: sharded output must be
bit-identical to single-device output (the analog of the reference's
BVH-vs-linear metamorphic toggle, SURVEY.md §4).  Sweep cases force the
culled sweep in interpret mode."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from raytpu.core import scenes
from raytpu.core.types import RenderConfig
from raytpu.grad import diff_render
from raytpu.parallel import make_mesh, render_image_sharded
from raytpu.parallel.training import make_sharded_train_step

CFG = RenderConfig(width=64, height=48)


@pytest.fixture(scope="module")
def scene():
    return scenes.get("reference").build()


@pytest.fixture(scope="module")
def single_device_image(scene):
    from raytpu.render import render_image

    return np.asarray(render_image(scene, CFG))


def test_eight_devices_available():
    assert len(jax.devices()) == 8


@pytest.mark.parametrize("px,prim", [(8, 1), (4, 2), (2, 4), (1, 8)])
def test_sharded_render_bit_identical(scene, single_device_image, px, prim):
    mesh = make_mesh(px=px, prim=prim)
    img = np.asarray(render_image_sharded(scene, CFG, mesh))
    np.testing.assert_array_equal(img, single_device_image)


@pytest.mark.parametrize("px,prim", [(8, 1), (2, 4)])
def test_sharded_sweep_bit_identical(px, prim):
    """The sweep forced on every shard (interpret mode) matches the
    one-device sweep render, which matches jnp."""
    from raytpu.render import render_image

    bunny = scenes.get("bunny").build()
    cfg = RenderConfig(width=64, height=32)
    ref = np.asarray(render_image(bunny, cfg, sweep=True, interpret=True))
    np.testing.assert_array_equal(ref, np.asarray(render_image(bunny, cfg)))
    img = np.asarray(render_image_sharded(bunny, cfg, make_mesh(px=px, prim=prim),
                                          sweep=True, interpret=True))
    np.testing.assert_array_equal(img, ref)


@pytest.mark.parametrize("size", [(64, 32), (64, 48)])
def test_sharded_sweep_fold_orders(size):
    """px-only sharding with the sweep forced: 32-divisible frames go in
    block order, others row-major; both must match the jnp frame."""
    from raytpu.render import render_image

    bunny = scenes.get("bunny").build()
    cfg = RenderConfig(width=size[0], height=size[1])
    ref = np.asarray(render_image(bunny, cfg))
    img = np.asarray(render_image_sharded(bunny, cfg, make_mesh(px=8, prim=1),
                                          sweep=True, interpret=True))
    np.testing.assert_array_equal(img, ref)


def test_prim_sharding_with_non_divisible_triangles(single_device_image):
    # bunny has 292 triangles, not divisible by 8 -> exercises padding
    bunny = scenes.get("bunny").build()
    mesh = make_mesh(px=2, prim=4)
    from raytpu.render import render_image

    ref = np.asarray(render_image(bunny, CFG))
    img = np.asarray(render_image_sharded(bunny, CFG, mesh))
    np.testing.assert_array_equal(img, ref)


def test_sharded_train_step_matches_single_device(scene):
    cfg = RenderConfig(width=32, height=24)
    target = jnp.zeros((24, 32, 3), jnp.float32)
    opt = optax.sgd(1e-2)
    params0 = diff_render.material_params(scene)

    # single-device reference step
    step1 = diff_render.make_train_step(
        cfg, opt, diff_render.material_params, diff_render.merge_material_params
    )
    # make_train_step's loss is mean over pixels; replicate that normalization
    p1, _, loss1 = step1(
        jax.tree_util.tree_map(jnp.copy, params0), opt.init(params0), scene, target
    )

    # 8-way pixel-sharded step
    mesh = make_mesh(px=8, prim=1)
    step8 = make_sharded_train_step(
        cfg, opt, diff_render.material_params, diff_render.merge_material_params, mesh
    )
    p8, _, loss8 = step8(
        jax.tree_util.tree_map(jnp.copy, params0), opt.init(params0), scene, target
    )

    np.testing.assert_allclose(float(loss1), float(loss8), rtol=1e-5)
    for a, b in zip(jax.tree_util.tree_leaves(p1), jax.tree_util.tree_leaves(p8)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-4, atol=1e-6)


def test_graft_entry_dryrun():
    import __graft_entry__ as g

    g.dryrun_multichip(8)


def test_scaling_harness_runs():
    from raytpu.parallel.scaling import scaling_report

    rows = scaling_report(size=(64, 48), frames=1)
    assert [r["devices"] for r in rows] == [1, 2, 4, 8]
    assert all(r["primary_rays_per_s"] > 0 for r in rows)
    assert rows[0]["efficiency"] == 1.0


def test_sharded_render_tiled_bit_identical(single_device_image):
    """32-divisible resolutions fold rays into mega2 tile order before
    shard_map; the unfold must restore row-major order exactly."""
    bunny = scenes.get("bunny").build()
    cfg = RenderConfig(width=64, height=32)
    from raytpu.render import render_image

    ref = np.asarray(render_image(bunny, cfg))
    mesh = make_mesh(px=2, prim=4)
    img = np.asarray(render_image_sharded(bunny, cfg, mesh))
    np.testing.assert_array_equal(img, ref)


def test_sharded_render_sweep_tiled_bit_identical():
    """px x prim sharding with the sweep forced on a 32-divisible frame:
    rays fold into block order before shard_map and back after."""
    bunny = scenes.get("bunny").build()
    cfg = RenderConfig(width=64, height=32)
    from raytpu.render import render_image

    ref = np.asarray(render_image(bunny, cfg))
    mesh = make_mesh(px=2, prim=4)
    img = np.asarray(render_image_sharded(bunny, cfg, mesh, sweep=True, interpret=True))
    np.testing.assert_array_equal(img, ref)


def test_sharded_ssaa_matches_single_device():
    """SSAA composes with sharding: the supersampled
    grid shards like any other resolution, box filter applied after."""
    from raytpu.parallel.sharding import _render_sharded_jit
    from raytpu.render.renderer import render_image_f32, render_image_ssaa

    bunny = scenes.get("bunny").build()
    cfg = RenderConfig(width=32, height=24)
    ref = np.asarray(render_image_ssaa(bunny, cfg, samples=2,
                                       render_fn=render_image_f32))
    mesh = make_mesh(px=4, prim=2)
    base = lambda s, c: _render_sharded_jit(s, c, mesh, sweep=False)
    img = np.asarray(render_image_ssaa(bunny, cfg, samples=2, render_fn=base))
    np.testing.assert_array_equal(img, ref)


def test_sharded_train_step_sweep_matches():
    """Sharded step with the sweep forced (interpret mode) and a
    32-divisible resolution — exercises the block-order ray/target fold
    inside the step — must match the single-device sweep step."""
    bunny = scenes.get("bunny").build()
    cfg = RenderConfig(width=64, height=32)
    target = jnp.zeros((32, 64, 3), jnp.float32)
    opt = optax.sgd(1e-2)
    params0 = diff_render.material_params(bunny)

    step1 = diff_render.make_train_step(
        cfg, opt, diff_render.material_params, diff_render.merge_material_params,
        sweep=True, interpret=True,
    )
    p1, _, loss1 = step1(
        jax.tree_util.tree_map(jnp.copy, params0), opt.init(params0), bunny, target
    )

    mesh = make_mesh(px=8, prim=1)
    step8 = make_sharded_train_step(
        cfg, opt, diff_render.material_params, diff_render.merge_material_params, mesh,
        sweep=True, interpret=True,
    )
    p8, _, loss8 = step8(
        jax.tree_util.tree_map(jnp.copy, params0), opt.init(params0), bunny, target
    )

    np.testing.assert_allclose(float(loss1), float(loss8), rtol=1e-5)
    for a, b in zip(jax.tree_util.tree_leaves(p1), jax.tree_util.tree_leaves(p8)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-4, atol=1e-6)
