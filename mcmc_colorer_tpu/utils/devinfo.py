"""What a measurement ran on: the JAX device and, on an NVIDIA card, its
name and power limit as ``nvidia-smi`` reports them (a card set below its
maximum power runs slower under load, so every number is kept beside
them)."""

from __future__ import annotations

import shutil
import subprocess

import jax


def nvidia_smi() -> str | None:
    """``name, power.limit`` of each card, one per line; None where
    ``nvidia-smi`` is absent.  Runs as a child process that never touches
    JAX."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return None
    out = subprocess.run(
        [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        timeout=60,
        check=True,
    )
    return out.stdout.strip()


def device_record() -> dict:
    """Platform, ``device_kind`` and count of the default backend's
    devices, plus the ``nvidia-smi`` line."""
    devs = jax.devices()
    return {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
        "nvidia_smi": nvidia_smi(),
    }
