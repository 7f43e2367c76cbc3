#!/usr/bin/env python
"""Benchmark harness for one GPU — prints ONE JSON line with the flagship.

Flagship: the bonsai 256^3 trilinear raymarch at 1024x1024 (BASELINE.json
config 3) on the GPU path that ``vokselis.ops.backend`` dispatches to,
reported as Mrays/s. ``vs_baseline`` is measured / 500 (the north-star
target; the reference publishes no numbers of its own — BASELINE.md).

Every config reports, on stderr, the first call's seconds (compilation
included) on its own line, then the median and 90th-percentile frame (or
batch) time with the sample count, Mrays/s, and its error against the
oracle measured on the card, each line with the card's name and power
limit. Times come from the host clock around calls that end in
``block_until_ready``.

    python bench.py          # config 3
    python bench.py --all    # configs 1-5 (BASELINE.json)

It refuses to run when JAX's first device is not a GPU.
"""

from __future__ import annotations

import argparse
import itertools
import json
import math
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def _log(*a):
    print(*a, file=sys.stderr, flush=True)


def _report(name, rays, timing, err, card):
    rec = dict(config=name, **timing,
               mrays_s=rays / (timing["median_ms"] * 1e-3) / 1e6,
               err_vs_oracle=err, card=card)
    _log(f"{name}: first call {timing['first_call_s']:.2f} s "
         "(compilation included)")
    _log(f"{name}: median {timing['median_ms']:.3f} ms, p90 "
         f"{timing['p90_ms']:.3f} ms (n={timing['n']}) = "
         f"{rec['mrays_s']:.1f} Mrays/s; mean |d rgb| vs oracle "
         f"{err['mean_abs']:.3e}, max {err['max_abs']:.3e} [{card}]")
    _log(json.dumps(rec))
    return rec


def bench_bonsai(card, name="bonsai_1024", vol=None, width=1024, height=1024):
    """Config 3: one pose, one frame per call."""
    import jax

    from vokselis.core.camera import Camera
    from vokselis.ops import backend, reference
    from vokselis.utils.chip import image_error, time_calls
    from vokselis.volume.io import get_bonsai

    render, pack = backend.build_renderer(get_bonsai() if vol is None else vol)
    u = Camera.bonsai(width / height).uniform()
    f = jax.jit(lambda pk, cam: render(pk, cam, width, height))
    timing = time_calls(lambda: f(pack, u))
    with jax.default_matmul_precision("highest"):
        ref = reference.render_bonsai(pack, u, width=width, height=height)
    return _report(name, width * height, timing,
                   image_error(f(pack, u), ref), card)


def bench_orbit(card, width=1920, height=1080, n_poses=8):
    """Config 4: the orbiting camera at 1080p, one pose per call in turn;
    the error is the worst pose's."""
    import jax

    from vokselis.ops import backend, reference
    from vokselis.parallel.sharding import orbit_camera_batch
    from vokselis.utils.chip import image_error, time_calls
    from vokselis.volume.io import get_bonsai

    render, pack = backend.build_renderer(get_bonsai())
    cams = orbit_camera_batch(n_poses, aspect=width / height)
    poses = [jax.tree.map(lambda x, i=i: x[i], cams) for i in range(n_poses)]
    f = jax.jit(lambda pk, cam: render(pk, cam, width, height))
    cycle = itertools.cycle(poses)
    timing = time_calls(lambda: f(pack, next(cycle)), n=4 * n_poses)
    errs = []
    with jax.default_matmul_precision("highest"):
        for u in poses:
            ref = reference.render_bonsai(pack, u, width=width, height=height)
            errs.append(image_error(f(pack, u), ref))
    worst = max(errs, key=lambda e: e["mean_abs"])
    return _report("bonsai_1080p_orbit", width * height, timing, worst, card)


def bench_field(card, name, width=512, height=512):
    """Configs 1 and 2: the procedural marches. Their GPU path is the oracle
    compiled by XLA, so the error is measured against the same oracle run
    on the host CPU."""
    import jax

    from vokselis.core.camera import Camera
    from vokselis.ops import reference
    from vokselis.utils.chip import image_error, time_calls
    from vokselis.volume import fields

    u = Camera.xor(width / height).uniform()
    if name == "trig_512":
        def f(cam):
            return reference.render_field(cam, 0.0, field=fields.trig_field,
                                          width=width, height=height)
    else:
        def f(cam):
            return reference.render_compute_inline(cam, 0.0, width=width,
                                                   height=height)
    timing = time_calls(lambda: f(u))
    ref = f(jax.device_put(u, jax.devices("cpu")[0]))
    return _report(name, width * height, timing, image_error(f(u), ref), card)


def bench_views(card, n_views=64, view_res=512, dims=512):
    """Config 5: a time-varying 512^3 volume and 64 views @512^2 per batch.
    Every batch regenerates the density on the device (the fbm field,
    ``fields.generate_density_u8``) and renders all views in one launch;
    the march reads the uint8 volume directly, so there is no repack."""
    import jax

    from vokselis.ops import backend, reference
    from vokselis.parallel.sharding import orbit_camera_batch
    from vokselis.utils.chip import image_error, time_calls
    from vokselis.volume.fields import generate_density_u8

    max_steps = int(math.ceil(math.sqrt(3.0) * dims)) + 1
    frame = backend.bonsai_frame_fn()
    cams = orbit_camera_batch(n_views)

    @jax.jit
    def batch(t, cams):
        vol = generate_density_u8(t, dims)
        return jax.vmap(lambda c: frame(vol, c, width=view_res,
                                        height=view_res,
                                        max_steps=max_steps))(cams)

    times = (0.3 * k for k in itertools.count())
    timing = time_calls(lambda: batch(next(times), cams), n=10)

    @jax.jit
    def oracle(t, cams):
        vol = generate_density_u8(t, dims)
        return jax.lax.map(lambda c: reference.render_bonsai(
            vol, c, width=view_res, height=view_res, max_steps=max_steps),
            cams)

    with jax.default_matmul_precision("highest"):
        err = image_error(batch(0.7, cams), oracle(0.7, cams))
    return _report("views512", n_views * view_res * view_res, timing, err,
                   card)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--all", action="store_true",
                    help="run every BASELINE.json config")
    args = ap.parse_args()

    from vokselis.ops import backend
    from vokselis.utils.chip import card_line, device_record

    try:
        backend.require_gpu()
    except backend.UnsupportedPlatform as e:
        _log(f"bench.py: {e}")
        return 1
    card = card_line()
    device = device_record()
    _log(f"device: {device}; card: {card}")

    flag = bench_bonsai(card)
    if args.all:
        from vokselis.volume.io import dense_stress

        bench_field(card, "trig_512")
        bench_field(card, "xor_512")
        bench_bonsai(card, name="bonsai_1024_dense", vol=dense_stress())
        bench_orbit(card)
        bench_views(card)

    print(json.dumps({
        "metric": "Mrays/s (bonsai 256^3 @ 1024^2, exact march)",
        "value": round(flag["mrays_s"], 2),
        "unit": "Mrays/s",
        "vs_baseline": round(flag["mrays_s"] / 500.0, 4),
        "p50_ms": round(flag["median_ms"], 4),
        "p90_ms": round(flag["p90_ms"], 4),
        "n": flag["n"],
        "mean_err": flag["err_vs_oracle"]["mean_abs"],
        "device": device,
        "card": card,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
