"""The backend dispatch point, the compile-cache rule, and the GPU-only
entry points refusing to run on the CPU."""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

from vokselis.core.camera import Camera
from vokselis.ops import backend, reference
from vokselis.ops.pallas import march_bonsai
from vokselis.volume.io import get_bonsai

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_gpu_dispatches_to_the_kernel():
    assert (backend.bonsai_rays_fn("gpu")
            is march_bonsai.render_bonsai_rays_kernel)
    assert backend.bonsai_frame_fn("gpu") is march_bonsai.render_bonsai_kernel


def test_cpu_dispatches_to_the_oracle():
    assert backend.bonsai_rays_fn("cpu") is backend._oracle_rays
    assert backend.bonsai_frame_fn("cpu") is reference.render_bonsai


@pytest.mark.parametrize("name", ["rocm", "metal", "neuron", ""])
def test_other_platforms_raise(name):
    with pytest.raises(backend.UnsupportedPlatform):
        backend.bonsai_rays_fn(name)
    with pytest.raises(backend.UnsupportedPlatform):
        backend.bonsai_frame_fn(name)


def test_current_platform_is_the_cpu_here():
    assert backend.platform() == "cpu"
    with pytest.raises(backend.UnsupportedPlatform):
        backend.require_gpu()


def test_build_renderer_pack_is_the_u8_volume():
    vol = get_bonsai(16)
    render, pack = backend.build_renderer(vol)
    assert pack.dtype == jnp.uint8 and pack.shape == (16, 16, 16)
    np.testing.assert_array_equal(np.asarray(pack), vol)
    u = Camera.bonsai(1.0).uniform()
    img = np.asarray(render(pack, u, 24, 16, max_steps=32))
    want = np.asarray(reference.render_bonsai(pack, u, width=24, height=16,
                                              max_steps=32))
    np.testing.assert_array_equal(img, want)


def test_bonsai_renderer_matches_oracle():
    vol = get_bonsai(16)
    u = Camera.bonsai(1.0).uniform()
    img = np.asarray(backend.BonsaiRenderer(vol)(u, 20, 12, max_steps=32))
    want = np.asarray(reference.render_bonsai(jnp.asarray(vol), u, width=20,
                                              height=12, max_steps=32))
    assert img.shape == (12, 20, 4)
    np.testing.assert_array_equal(img, want)


def test_oracle_rays_take_soa_planes():
    """The CPU ray-set march accepts the kernel's SoA signature."""
    from vokselis.core import geometry

    vol = jnp.asarray(get_bonsai(16))
    u = Camera.bonsai(1.0).uniform()
    eye, dxyz = geometry.rays_fragment_soa(u, 16, 16)
    img = backend.bonsai_rays_fn("cpu")(vol, eye, dxyz, 32)
    want = reference.render_bonsai(vol, u, width=16, height=16, max_steps=32)
    # eager against jitted: the same ops, fused differently
    np.testing.assert_allclose(np.asarray(img), np.asarray(want), atol=1e-6)


def test_render_bonsai_follows_the_platform():
    vol = jnp.asarray(get_bonsai(16))
    u = Camera.bonsai(1.0).uniform()
    img = backend.render_bonsai(vol, u, width=16, height=16, max_steps=16)
    want = reference.render_bonsai(vol, u, width=16, height=16, max_steps=16)
    np.testing.assert_array_equal(np.asarray(img), np.asarray(want))


# ---------------------------------------------------------------------------
# compile cache: JAX_COMPILATION_CACHE_DIR when set, else <repo>/.jax_cache

_PROBE = ("import json, jax, vokselis; print(json.dumps("
          "[jax.config.jax_compilation_cache_dir, vokselis.CACHE_DIR]))")


def _cache_dirs(env_update):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(env_update, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env, cwd=ROOT,
                         capture_output=True, text=True, check=True,
                         timeout=120).stdout
    return json.loads(out.strip().splitlines()[-1])


def test_cache_defaults_to_a_fixed_path_in_the_checkout():
    cfg, ours = _cache_dirs({})
    assert cfg == ours == os.path.join(ROOT, ".jax_cache")


def test_cache_follows_the_environment(tmp_path):
    want = str(tmp_path / "cache")
    cfg, ours = _cache_dirs({"JAX_COMPILATION_CACHE_DIR": want})
    assert cfg == ours == want


# ---------------------------------------------------------------------------
# the GPU-only entry points


def _run_script(args, cwd, timeout=120):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


@pytest.mark.parametrize("args", [["chip_smoke.py"],
                                  ["chip_smoke.py", "--four-cards"],
                                  ["bench.py"], ["bench.py", "--all"]])
def test_gpu_scripts_refuse_the_cpu(args):
    p = _run_script(args, ROOT)
    assert p.returncode != 0
    assert '"ok"' not in p.stdout and "Mrays" not in p.stdout
    assert "needs a GPU" in p.stderr


def test_chip_smoke_alone_fails(tmp_path):
    """Without the rest of the repo the script fails and prints no result."""
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        (tmp_path / "chip_smoke.py").write_text(f.read())
    p = _run_script(["chip_smoke.py"], str(tmp_path))
    assert p.returncode != 0
    assert '"ok"' not in p.stdout


def test_no_interpret_mode_outside_tests():
    """Library code never forces interpret mode; only tests ask for it."""
    import pathlib

    for path in pathlib.Path(ROOT, "vokselis").rglob("*.py"):
        text = path.read_text()
        assert "interpret=True" not in text, path
