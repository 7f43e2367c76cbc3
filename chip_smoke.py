#!/usr/bin/env python
"""Smoke test of the main path on one NVIDIA GPU, in one process.

    python chip_smoke.py               # one card: phases 1-7
    python chip_smoke.py --four-cards  # four cards: the sharded paths only

Phases (one card), each printing its result on its own line:

1. the device: JAX's platform, device_kind and count, and the card's name
   and power limit from nvidia-smi;
2. compile the bonsai march kernel at 256^3 @1024^2, 256^3 @1920x1080 and
   512^3 @512^2: compile seconds and ``memory_analysis()``;
3. parity of the kernel with the jnp oracle on the card at 1024^2 (the
   bench pose, 4 orbit poses, the dense-stress volume): mean |d rgb| <= 1e-5
   and a share of pixels with |d| > 1e-3 of at most 1e-4;
4. the kernel against XLA's compile of the oracle at 1024^2, timed;
5. the engine loop end to end: the bonsai demo at 1280x720 for a few orbit
   frames (present, readback, PNG), then the xor and trig demos;
6. one config-5 batch: a 512^3 volume regenerated on the device and 64
   views @512^2;
7. the four golden images.

``--four-cards`` runs only the multi-device paths and what they are compared
with: 64 orbit views @512^2 sharded over a 4-device 'views' mesh and
gathered, against the same kernel on one card; and one 1024^2 frame with
its rows sharded over a 4-device 'tiles' mesh, against the one-card frame
(max |d| <= 1e-6).

Any failure exits non-zero. The last line is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
Without a GPU it exits non-zero before any phase and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

PARITY_MEAN = 1e-5
PARITY_SHARE = 1e-4
SHARDED_MAX = 1e-6


@contextlib.contextmanager
def phase(name):
    t0 = time.perf_counter()
    print(f"[{name}] start", flush=True)
    yield
    print(f"[{name}] ok in {time.perf_counter() - t0:.1f} s", flush=True)


def compile_phase():
    import jax
    import jax.numpy as jnp

    from vokselis.core.camera import CameraUniform
    from vokselis.ops.pallas import march_bonsai as mb

    s = jax.ShapeDtypeStruct
    cam = CameraUniform(s((4,), jnp.float32), s((4, 4), jnp.float32),
                        s((4, 4), jnp.float32))
    for n, w, h in ((256, 1024, 1024), (256, 1920, 1080), (512, 512, 512)):
        t0 = time.perf_counter()
        compiled = mb.render_bonsai_kernel.trace(
            s((n, n, n), jnp.uint8), cam, width=w, height=h).lower().compile()
        sec = time.perf_counter() - t0
        print(f"compile {n}^3 @{w}x{h}: {sec:.2f} s; memory_analysis: "
              f"{compiled.memory_analysis()}", flush=True)


def parity_phase():
    import jax
    import jax.numpy as jnp

    from vokselis.core.camera import Camera
    from vokselis.ops import backend, reference
    from vokselis.parallel.sharding import orbit_camera_batch
    from vokselis.utils.chip import image_error
    from vokselis.volume.io import dense_stress, get_bonsai

    orbit = orbit_camera_batch(4)
    bench = Camera.bonsai(1.0).uniform()
    cases = [("bench pose", get_bonsai(), bench)]
    cases += [(f"orbit pose {k}", get_bonsai(),
               jax.tree.map(lambda x, k=k: x[k], orbit)) for k in range(4)]
    cases += [("dense stress, bench pose", dense_stress(), bench)]
    render, _ = backend.build_renderer(get_bonsai())
    failed = []
    for name, vol, u in cases:
        vol = jnp.asarray(vol)
        img = render(vol, u, 1024, 1024)
        with jax.default_matmul_precision("highest"):
            ref = reference.render_bonsai(vol, u, width=1024, height=1024)
        e = image_error(img, ref)
        print(f"parity {name} @1024^2: mean |d| {e['mean_abs']:.3e}, max |d| "
              f"{e['max_abs']:.3e}, share |d|>1e-3 {e['share_gt_1e-3']:.3e}",
              flush=True)
        if e["mean_abs"] > PARITY_MEAN or e["share_gt_1e-3"] > PARITY_SHARE:
            failed.append(name)
    if failed:
        raise AssertionError(f"kernel/oracle parity failed: {failed}")


def timing_phase(card):
    import jax
    import jax.numpy as jnp

    from vokselis.core import geometry
    from vokselis.core.camera import Camera
    from vokselis.ops import reference
    from vokselis.ops.pallas import march_bonsai as mb
    from vokselis.utils.chip import time_calls
    from vokselis.volume.io import get_bonsai

    vol = jnp.asarray(get_bonsai())
    u = Camera.bonsai(1.0).uniform()
    march = jax.jit(lambda v, c: mb.march_rays(
        v, *geometry.rays_fragment_soa(c, 1024, 1024)))
    runs = {
        "kernel frame": lambda: mb.render_bonsai_kernel(
            vol, u, width=1024, height=1024),
        "kernel march only": lambda: march(vol, u),
    }
    with jax.default_matmul_precision("highest"):
        runs["XLA oracle frame"] = lambda: reference.render_bonsai(
            vol, u, width=1024, height=1024)
        res = {k: time_calls(f, n=20) for k, f in runs.items()}
    for k, t in res.items():
        print(f"time {k} @1024^2: median {t['median_ms']:.4f} ms, p90 "
              f"{t['p90_ms']:.4f} ms (n={t['n']}), "
              f"{1024 * 1024 / t['median_ms'] / 1e3:.1f} Mrays/s [{card}]",
              flush=True)
    k, o = res["kernel frame"]["median_ms"], res["XLA oracle frame"]["median_ms"]
    print(f"kernel vs XLA oracle @1024^2: {o / k:.2f}x [{card}]", flush=True)


def engine_phase(out_dir):
    import numpy as np

    from vokselis.engine.loop import run
    from vokselis.media.png import write_png
    from vokselis.models.bonsai import BonsaiDemo
    from vokselis.models.trig import TrigDemo
    from vokselis.models.xor import XorDemo

    def orbit(frames):
        yield {"type": "mouse_button", "pressed": True}
        for i in range(frames):
            yield {"type": "mouse_move", "x": 640.0 + 8.0 * i, "y": 360.0,
                   "dragging": True}
            yield None

    os.makedirs(out_dir, exist_ok=True)
    for demo in (BonsaiDemo, XorDemo, TrigDemo):
        t0 = time.perf_counter()
        ctx = run(demo, width=1280, height=720,
                  camera=demo.default_camera(1280 / 720), frames=4,
                  events=orbit(4), quiet=True)
        frame = ctx.capture_frame()  # device_get + uint8
        path = os.path.join(out_dir, f"{demo.__name__}.png")
        write_png(path, frame)
        assert frame.shape[:2] == (720, 1280), frame.shape
        assert frame.max() > 0, f"{demo.__name__} rendered a black frame"
        assert np.isfinite(np.asarray(ctx.display_image)).all()
        print(f"engine {demo.__name__} 1280x720, 4 frames: "
              f"{time.perf_counter() - t0:.1f} s, wrote {path}", flush=True)


def views_phase():
    import jax
    import numpy as np

    from vokselis.ops import backend, reference
    from vokselis.parallel.sharding import orbit_camera_batch
    from vokselis.utils.chip import image_error
    from vokselis.volume.fields import generate_density_u8

    dims, res, n_views = 512, 512, 64
    max_steps = int(math.ceil(math.sqrt(3.0) * dims)) + 1
    frame = backend.bonsai_frame_fn()
    cams = orbit_camera_batch(n_views)

    @jax.jit
    def batch(t, cams):
        vol = generate_density_u8(t, dims)
        imgs = jax.vmap(lambda c: frame(vol, c, width=res, height=res,
                                        max_steps=max_steps))(cams)
        return vol, imgs

    t0 = time.perf_counter()
    vol, imgs = jax.block_until_ready(batch(0.7, cams))
    imgs = np.asarray(imgs)
    assert imgs.shape == (n_views, res, res, 4), imgs.shape
    assert np.isfinite(imgs).all()
    with jax.default_matmul_precision("highest"):
        for k in (0, 21, 42):
            ref = reference.render_bonsai(
                vol, jax.tree.map(lambda x, k=k: x[k], cams), width=res,
                height=res, max_steps=max_steps)
            e = image_error(imgs[k], ref)
            assert e["mean_abs"] <= PARITY_MEAN, (k, e)
    print(f"config 5: 512^3 regenerated + 64 views @512^2 in "
          f"{time.perf_counter() - t0:.1f} s (first call), finite; views "
          f"0/21/42 match the oracle (last mean |d| {e['mean_abs']:.3e})",
          flush=True)


def goldens_phase():
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import golden_scenes as goldens

    for name in goldens.SCENES:
        e = goldens.check(name, goldens.render(name))
        print(f"golden {name}: mean {e['mean']:.4f} levels, share >8 "
              f"{e['share_gt_8']:.4f}", flush=True)


def four_cards_phase(card, n_views=64, view_res=512, frame_res=1024,
                     vol_n=256):
    import jax
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from vokselis.core.camera import Camera
    from vokselis.ops import backend
    from vokselis.parallel.sharding import (
        build_ray_renderer,
        make_mesh,
        multi_view_step,
        orbit_camera_batch,
        render_frame_tiled,
        render_views_sharded,
    )
    from vokselis.utils.chip import time_calls
    from vokselis.volume.io import get_bonsai

    devices = jax.devices()
    if len(devices) != 4:
        raise RuntimeError(f"--four-cards needs 4 GPUs, found {len(devices)}")
    vol = get_bonsai(vol_n)
    steps = int(math.ceil(math.sqrt(3.0) * vol_n)) + 1
    renderer = backend.build_renderer(vol)
    render, pack = renderer

    # views: orbit views over a 4-device 'views' mesh, gathered
    mesh = make_mesh(views=4, tiles=1)
    cams = orbit_camera_batch(n_views)
    cams_sharded = jax.device_put(
        cams, jax.tree.map(lambda _: NamedSharding(mesh, P("views")), cams))
    views = np.asarray(multi_view_step(
        mesh, None, n_views, view_res, view_res, max_steps=steps,
        gather=True, renderer=renderer))
    one = jax.jit(lambda pk, c: render(pk, c, view_res, view_res, steps))
    worst = 0.0
    for k in range(n_views):
        ref = np.asarray(one(pack, jax.tree.map(lambda x, k=k: x[k], cams)))
        worst = max(worst, float(np.abs(views[k] - ref).max()))
    print(f"four cards, views mesh (4x1), {n_views} views @{view_res}^2 "
          f"+ all_gather: max |d| vs one card {worst:.3e}", flush=True)
    for gather in (False, True):
        t = time_calls(lambda g=gather: render_views_sharded(
            mesh, render, pack, cams_sharded, view_res, view_res,
            max_steps=steps, gather=g), n=10)
        print(f"four cards, views mesh, gather={gather}: median "
              f"{t['median_ms']:.3f} ms p90 {t['p90_ms']:.3f} ms "
              f"(n={t['n']}) [{card}]", flush=True)
    batched = jax.jit(jax.vmap(
        lambda pk, c: render(pk, c, view_res, view_res, steps),
        in_axes=(None, 0)))
    t = time_calls(lambda: batched(pack, cams), n=10)
    print(f"one card, the same {n_views} views: median {t['median_ms']:.3f} "
          f"ms p90 {t['p90_ms']:.3f} ms (n={t['n']}) [{card}]", flush=True)
    if worst > SHARDED_MAX:
        raise AssertionError(f"views: max |d| {worst} > {SHARDED_MAX}")

    # rows: one frame over a 4-device 'tiles' mesh
    mesh = make_mesh(views=1, tiles=4)
    rays = build_ray_renderer(vol)
    u = Camera.bonsai(1.0).uniform()
    run_rows = lambda: render_frame_tiled(  # noqa: E731
        mesh, None, u, frame_res, frame_res, max_steps=steps, renderer=rays)
    rows = np.asarray(run_rows())
    ref = np.asarray(render(pack, u, frame_res, frame_res, steps))
    worst = float(np.abs(rows - ref).max())
    t = time_calls(run_rows, n=20)
    print(f"four cards, tiles mesh (1x4), {frame_res}^2 frame: max |d| vs "
          f"one card {worst:.3e}; median {t['median_ms']:.3f} ms p90 "
          f"{t['p90_ms']:.3f} ms (n={t['n']}) [{card}]", flush=True)
    if worst > SHARDED_MAX:
        raise AssertionError(f"rows: max |d| {worst} > {SHARDED_MAX}")


def main():
    ap = argparse.ArgumentParser(description="GPU smoke test")
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-GPU sharded paths")
    ap.add_argument("--out", default=os.path.join(ROOT, "out", "chip_smoke"),
                    help="directory for the engine phase's PNGs")
    args = ap.parse_args()

    from vokselis.ops import backend
    from vokselis.utils.chip import card_line, device_record

    try:
        backend.require_gpu()
    except backend.UnsupportedPlatform as e:
        print(f"chip_smoke.py: {e}", file=sys.stderr)
        return 2
    device = device_record()
    card = card_line()
    print(f"device: platform {device['platform']}, kind {device['kind']}, "
          f"count {device['count']}", flush=True)
    print(f"card: {card}", flush=True)

    if args.four_cards:
        with phase("four cards"):
            four_cards_phase(card)
    else:
        with phase("compile"):
            compile_phase()
        with phase("parity"):
            parity_phase()
        with phase("timing"):
            timing_phase(card)
        with phase("engine"):
            engine_phase(args.out)
        with phase("config 5"):
            views_phase()
        with phase("goldens"):
            goldens_phase()

    print(card, flush=True)
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
