"""Committed golden-buffer regression test: the full-resolution default scene
must keep rendering the same image (the analog of the reference's
committed benchmark.txt + screenshot workflow, SURVEY.md §4)."""

from pathlib import Path

import numpy as np

from raytpu.core import scenes
from raytpu.core.types import RenderConfig
from raytpu.render import render_image

GOLDEN_DIR = Path(__file__).parent / "golden"


def _check_golden(img, name):
    from raytpu.utils.image import FLIP_BUDGET, MEAN_DIFF_BUDGET, flip_stats, read_png

    flipped, mean_diff = flip_stats(img, read_png(str(GOLDEN_DIR / name)))
    # tiny boundary-flip budget for fp reassociation across jax versions
    assert flipped <= FLIP_BUDGET, f"{flipped:.4%} pixels flipped vs {name}"
    assert mean_diff <= MEAN_DIFF_BUDGET


def test_reference_scene_matches_committed_golden():
    img = np.asarray(
        render_image(scenes.get("reference").build(), RenderConfig(width=640, height=480))
    )
    _check_golden(img, "reference_640x480.png")


def test_animated_frame_matches_committed_golden():
    """Mid-animation frame (t=1.25: meshes yawed by the reference's
    (cos t + 1)/2 * 2pi curve, reference: source/Scene.cpp:394)."""
    spec = scenes.get("reference")
    img = np.asarray(
        render_image(spec.animate(spec.build(), 1.25), RenderConfig(width=640, height=480))
    )
    _check_golden(img, "reference_t1.25_640x480.png")


def test_ssaa_matches_committed_golden():
    """2x2 supersampled render (capability the reference lacks)."""
    from raytpu.render.renderer import render_image_ssaa

    img = np.asarray(
        render_image_ssaa(scenes.get("reference").build(), RenderConfig(width=320, height=240), samples=2)
    )
    _check_golden(img, "reference_ssaa2_320x240.png")
