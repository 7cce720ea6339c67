"""App-shell tests: the CLI frame loop and the interactive viewer.

The reference's app shell (reference: source/main.cpp:23-121) is manual-only;
these pin the replacement's end-to-end behavior: screenshot writing, the
4-line ``benchmark.txt`` format (reference: source/Timer.cpp:123-128), flag
validation, and a headless interactive smoke run.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent


def _run_cli(args, timeout=240, env_extra=None):
    env = dict(os.environ)
    if env_extra:
        env.update(env_extra)
    return subprocess.run(
        [sys.executable, "-m", "raytpu.app.cli", "--platform", "cpu", *args],
        capture_output=True,
        text=True,
        timeout=timeout,
        cwd=REPO,
        env=env,
    )


def test_cli_screenshot_and_benchmark(tmp_path):
    shot = tmp_path / "shot.bmp"
    bench_out = tmp_path / "benchmark.txt"
    proc = _run_cli(
        [
            "--scene", "w2",
            "--size", "64x48",
            "--benchmark", "2",
            "--benchmark-out", str(bench_out),
            "--screenshot", str(shot),
        ]
    )
    assert proc.returncode == 0, proc.stderr[-2000:]

    # screenshot: a real image with non-trivial content
    from raytpu.utils.image import read_bmp

    img = read_bmp(str(shot))
    assert img.shape == (48, 64, 3) and img.dtype == np.uint8
    assert img.any()

    # benchmark.txt: the reference's exact 4-line shape
    # (reference: source/Timer.cpp:123-128)
    lines = bench_out.read_text().splitlines()
    assert len(lines) == 4
    assert lines[0].startswith("FPS BENCHMARK of ")
    assert lines[1].startswith("HIGH: ")
    assert lines[2].startswith("LOW: ")
    assert lines[3].startswith("AVERAGE: ")
    high = float(lines[1].split(": ")[1])
    low = float(lines[2].split(": ")[1])
    avg = float(lines[3].split(": ")[1])
    assert low <= avg <= high

    assert "**BENCHMARK STARTED" in proc.stdout
    assert "**BENCHMARK FINISHED**" in proc.stdout


def test_cli_bmp_screenshot(tmp_path):
    """BMP screenshots match the reference's X-key output format
    (reference: source/Renderer.cpp:184-187)."""
    shot = tmp_path / "RayTracing_Buffer.bmp"
    proc = _run_cli(["--scene", "sphere", "--size", "32x24", "--screenshot", str(shot)])
    assert proc.returncode == 0, proc.stderr[-2000:]
    data = shot.read_bytes()
    assert data[:2] == b"BM"  # BMP magic
    assert len(data) >= 32 * 24 * 3


def test_cli_renderer_fallback_jnp(tmp_path):
    shot = tmp_path / "s.png"
    proc = _run_cli(["--scene", "sphere", "--size", "32x24", "--renderer", "jnp",
                     "--screenshot", str(shot)])
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "backend=jnp" in proc.stdout
    assert shot.exists()


def test_cli_lighting_mode_and_shadow_flags(tmp_path):
    """Debug lighting modes must change the image (reference: F3 modes,
    source/Renderer.cpp:155-170)."""
    imgs = {}
    from raytpu.utils.image import read_bmp

    for mode in ("combined", "observed_area"):
        shot = tmp_path / f"{mode}.bmp"
        proc = _run_cli(["--scene", "w2", "--size", "32x24", "--mode", mode,
                         "--screenshot", str(shot)])
        assert proc.returncode == 0, proc.stderr[-2000:]
        imgs[mode] = read_bmp(str(shot))
    assert (imgs["combined"] != imgs["observed_area"]).any()


def test_cli_soft_shadows_flag(tmp_path):
    """--soft-shadows renders the differentiable path's sigmoid visibility;
    a low beta must visibly soften shadow edges vs the hard render."""
    from raytpu.utils.image import read_bmp

    imgs = {}
    for name, flags in (("hard", []), ("soft", ["--soft-shadows", "--soft-beta", "40"])):
        shot = tmp_path / f"{name}.bmp"
        proc = _run_cli(["--scene", "w2", "--size", "32x24",
                         "--screenshot", str(shot)] + flags)
        assert proc.returncode == 0, proc.stderr[-2000:]
        imgs[name] = read_bmp(str(shot))
    assert (imgs["hard"] != imgs["soft"]).any()


def test_cli_invalid_flags():
    assert _run_cli(["--size", "banana"]).returncode == 2
    assert _run_cli(["--size", "0x0"]).returncode == 2
    assert _run_cli(["--ssaa", "0"]).returncode == 2


def test_cli_stats_line(tmp_path):
    proc = _run_cli(["--scene", "sphere", "--size", "32x24", "--frames", "2"])
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "primary_rays/s=" in proc.stdout
    assert "frames=2" in proc.stdout


@pytest.mark.skipif(
    subprocess.run([sys.executable, "-c", "import pygame"], capture_output=True).returncode != 0,
    reason="pygame not installed",
)
def test_interactive_headless_smoke():
    """Interactive viewer runs headless for 2 frames and exits cleanly
    (reference: the SDL window loop, source/main.cpp:56-111)."""
    proc = subprocess.run(
        [
            sys.executable, "-m", "raytpu.app.interactive",
            "--scene", "sphere", "--size", "32x24",
            "--max-frames", "2", "--platform", "cpu",
        ],
        capture_output=True,
        text=True,
        timeout=240,
        cwd=REPO,
        env={**os.environ, "SDL_VIDEODRIVER": "dummy", "SDL_AUDIODRIVER": "dummy"},
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "raytpu interactive" in proc.stdout


def test_cli_frames_per_dispatch(tmp_path):
    """--frames-per-dispatch K renders K frames per lax.scan dispatch
    (amortizing per-dispatch host latency); the frame
    count and screenshot must match the per-frame loop's behavior."""
    shot = tmp_path / "shot.png"
    proc = _run_cli(
        ["--scene", "w2", "--size", "64x48", "--frames", "6",
         "--frames-per-dispatch", "3", "--screenshot", str(shot)]
    )
    assert proc.returncode == 0, proc.stderr
    assert "compile scan dispatch (K=3)" in proc.stdout
    assert "frames=6 " in proc.stdout
    assert shot.exists()


def test_cli_frames_per_dispatch_tail(tmp_path):
    """--frames not a multiple of K: the tail dispatch repeats the last
    requested frame's time, so the screenshot is frame n_frames (not a
    frame past it) and exactly --frames frames are counted."""
    shot = tmp_path / "shot.png"
    proc = _run_cli(
        ["--scene", "w2", "--size", "64x48", "--frames", "5",
         "--frames-per-dispatch", "3", "--screenshot", str(shot)]
    )
    assert proc.returncode == 0, proc.stderr
    assert "frames=5 " in proc.stdout
    assert shot.exists()
