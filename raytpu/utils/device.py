"""What a measurement ran on: JAX's device description and the card's name
and power limit as ``nvidia-smi`` reports them."""

from __future__ import annotations

import shutil
import subprocess


def describe() -> dict:
    """``{"platform", "kind", "count"}`` of the default JAX devices."""
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind, "count": len(devs)}


def card_name_and_power_limit() -> str:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    (one line per card), or ``"nvidia-smi not available"``."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return "nvidia-smi not available"
    out = subprocess.run([exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip() or f"nvidia-smi failed: {out.stderr.strip()}"


def require_gpu() -> dict:
    """The device description; raises SystemExit(1) unless JAX's default
    devices are GPUs (measurements never fall back to the CPU)."""
    desc = describe()
    if desc["platform"] != "gpu":
        raise SystemExit(f"no GPU: JAX's default devices are {desc}")
    return desc
