"""Device identification and timing for measurements on a GPU.

Every number a measurement prints names the card it ran on: JAX's view of
the device (platform, device_kind, count) and the card's name and power
limit as ``nvidia-smi`` reports them (a card set below its maximum power
runs slower under load).
"""

from __future__ import annotations

import subprocess
import time

import jax
import numpy as np


def card_line() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` for the first card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    return out.splitlines()[0]


def device_record() -> dict:
    dev = jax.devices()[0]
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}


def time_calls(fn, n: int = 20, warmup: int = 2) -> dict:
    """Compile (first call) and time ``fn`` with ``block_until_ready``.

    Returns the first call's seconds (compilation included) and the median
    and 90th percentile of ``n`` timed calls after ``warmup`` more."""
    t0 = time.perf_counter()
    jax.block_until_ready(fn())
    first_s = time.perf_counter() - t0
    for _ in range(warmup):
        jax.block_until_ready(fn())
    samples = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        samples.append(time.perf_counter() - t0)
    return {
        "first_call_s": first_s,
        "median_ms": float(np.median(samples)) * 1e3,
        "p90_ms": float(np.percentile(samples, 90)) * 1e3,
        "n": n,
    }


def image_error(img, ref) -> dict:
    """Per-pixel rgb error of ``img`` against ``ref`` (..., >=3 channels):
    the mean and max of |Δ|, and the share of pixels whose largest channel
    error exceeds 1e-3."""
    d = np.abs(np.asarray(img, np.float64)[..., :3]
               - np.asarray(ref, np.float64)[..., :3])
    return {"mean_abs": float(d.mean()), "max_abs": float(d.max()),
            "share_gt_1e-3": float((d.max(axis=-1) > 1e-3).mean())}
