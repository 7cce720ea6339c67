"""REAL multi-process distributed execution.

Spawns 2 OS processes, each with 2 CPU devices, wired by
``jax.distributed.initialize`` (Gloo collectives).  Two mesh layouts run:
the default (px=2, prim=2) pod mesh (px across processes — the training
gradient psum and image gather cross the process boundary) and a
transposed mesh whose PRIM axis spans the processes, so the closest-hit
winner-merge all-gather itself crosses processes too.  No mocks, no
virtual single-process mesh.

Asserts the cross-process sharded render is bit-identical to a
single-process render and the psum'd train step matches the single-device
step — the distributed analog of the reference's in-process fan-out, which
also actually executes every frame (reference: source/Renderer.cpp:42-85).
"""

import numpy as np

from raytpu.parallel import launch


def test_two_process_distributed_render_and_train(tmp_path):
    # launch.spawn enforces its own 540 s wall-clock timeout on the workers
    results = launch.spawn(2, str(tmp_path), timeout=540.0, local_devices=2)

    assert len(results) == 2
    for r in results:
        assert r["process_count"] == 2
        assert r["global_devices"] == 4
        assert r["mesh"] == {"px": 2, "prim": 2}
        # cross-process sharded render == single-process render, bit for bit
        assert r["render_identical_to_single_process"]
        # and with the prim axis spanning processes (winner-merge crosses)
        assert r["render_xprim_identical_to_single_process"]
        # cross-process psum'd gradient step == single-device step
        assert r["loss_match"]
        assert r["params_match_single_process"]

    # both controllers fetched the same replicated frame
    img0 = np.load(tmp_path / "img_p0.npy")
    img1 = np.load(tmp_path / "img_p1.npy")
    np.testing.assert_array_equal(img0, img1)

    # and it matches this (third) process's own render of the same scene
    from raytpu.core import scenes
    from raytpu.core.types import RenderConfig
    from raytpu.render import render_image

    ref = np.asarray(render_image(scenes.get("reference").build(),
                                  RenderConfig(width=64, height=48)))
    np.testing.assert_array_equal(img0, ref)
