"""The GPU route without a GPU: every kernel variant lowers for CUDA
through Pallas's Triton backend (the ``__gpu$xla.gpu.triton`` custom call),
the interpret/backend resolution rules, the compile-cache helper, and the
entry points that must refuse to run without a card.  Tests marked ``gpu``
run the kernels compiled on the card (chip_smoke.py's ``gpu-tests``
phase)."""

import json
import os
import pathlib
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raymarching_tpu import RenderConfig, compile_scene, load_scene
from raymarching_tpu.api import render_tables, resolve_backend
from raymarching_tpu.ops import pallas_march as pm
from raymarching_tpu.ops import pallas_render as pr

REPO = pathlib.Path(__file__).resolve().parent.parent
R = 384                      # rays per lowering case (3 blocks of 128)
BLOCK = 128


def _lowered_triton_calls(fn, *args) -> int:
    """Lower ``fn`` for CUDA on this host; count Triton custom calls."""
    text = jax.jit(fn).trace(*args).lower(
        lowering_platforms=("cuda",)).as_text()
    return text.count("__gpu$xla.gpu.triton")


@pytest.fixture(scope="module")
def small_scene():
    # mirror.txt: a Menger sponge, a DeathStar, spheres, a box floor and
    # colored lights — every group kind, at a small primitive count
    return compile_scene(load_scene(str(REPO / "scenes" / "mirror.txt")))


def _rays(tables):
    d = np.tile(np.asarray([[0.1, -0.35, -1.0]], np.float32), (R, 1))
    d[:, 0] += np.linspace(-0.4, 0.4, R, dtype=np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = np.broadcast_to(np.asarray(tables.cam_position, np.float32), d.shape)
    return jnp.asarray(o), jnp.asarray(d)


MARCH = {"plain": {}, "tmax_steps": {"tmax": True, "with_steps": True}}


@pytest.mark.parametrize("variant", sorted(MARCH))
def test_march_kernel_lowers_for_cuda(small_scene, variant):
    plan, tables = small_scene
    kp = pm.kernel_key(plan)
    o, d = _rays(tables)
    kw = dict(MARCH[variant])
    tmax = jnp.full((R,), 3.0) if kw.pop("tmax", False) else None

    def f(o, d):
        out = pm.pallas_march(kp, 40, 1e-3, BLOCK, o, d, tables, tmax=tmax,
                              interpret=False, **kw)
        return out[1] if kw.get("with_steps") else out.sd

    assert _lowered_triton_calls(f, o, d) == 1


SURFACE = {"sd": dict(with_color=False, with_normal=False),
           "color": dict(with_color=True, with_normal=False),
           "fd_normal": dict(with_color=False, with_normal=True),
           "winner": dict(with_color=True, with_normal=True, analytic=True)}


@pytest.mark.parametrize("mode", sorted(SURFACE))
def test_surface_kernel_lowers_for_cuda(small_scene, mode):
    plan, tables = small_scene
    kp = pm.kernel_key(plan)
    o, d = _rays(tables)
    p = o + 4.0 * d
    assert _lowered_triton_calls(
        lambda p: pm.pallas_surface_eval(kp, 1e-3, BLOCK, p, tables,
                                         interpret=False,
                                         **SURFACE[mode])[0], p) == 1


_CFG = RenderConfig(width=16, height=12, ssaa=2, iterations=40,
                    ray_block=BLOCK)
MEGA = {
    "exact_fd": _CFG,
    "exact_analytic": _CFG.replace(normal_mode="analytic"),
    "fused_analytic": _CFG.replace(normal_mode="analytic",
                                   fused_generators=True),
    "bounces_soft_ao": _CFG.replace(reflect_strength=0.4, soft_shadow_k=8.0,
                                    ao_strength=0.5),
}


@pytest.mark.parametrize("regime", sorted(MEGA) + ["per_ray_origin",
                                                   "serve_raygen",
                                                   "two_phase_shade"])
def test_mega_kernel_lowers_for_cuda(small_scene, regime):
    plan, tables = small_scene
    o, d = _rays(tables)
    cfg = MEGA.get(regime, _CFG)
    if regime == "two_phase_shade":
        cfg = cfg.replace(two_phase_k1=10)
    if regime == "serve_raygen":
        def f(d):
            return pr.pallas_render_rays(
                plan, cfg, tables.cam_position, None, tables,
                interpret=False, raygen=(16, 12, 2, 4, 4),
                ray_base=jnp.int32(0), n_rays=R)[4]
    else:
        org = o if regime == "per_ray_origin" else tables.cam_position

        def f(d):
            return pr.pallas_render_rays(plan, cfg, org, d, tables,
                                         interpret=False)[4]
    # two-phase: three march launches (phase 1, phase 2, fallback) + shade
    want = 4 if regime == "two_phase_shade" else 1
    assert _lowered_triton_calls(f, d) == want


def test_demo_scene_mega_kernel_lowers_for_cuda():
    """The bench scene's lattice-collapsed Menger fold and black-lane
    shadow skip lower too."""
    plan, tables = compile_scene(load_scene(str(REPO / "scenes" /
                                                "demo.txt")))
    _, d = _rays(tables)
    assert _lowered_triton_calls(
        lambda d: pr.pallas_render_rays(plan, _CFG, tables.cam_position, d,
                                        tables, interpret=False)[4], d) == 1


# ------------------------------------------------------- resolution rules

def test_interpret_resolves_to_cpu_rule():
    assert jax.default_backend() == "cpu"
    assert pm.resolve_interpret(None) is True
    assert pm.resolve_interpret(True) is True
    assert pm.resolve_interpret(False) is False


def test_auto_backend_is_jnp_on_cpu_and_explicit_passes_through():
    assert resolve_backend("auto") == "jnp"
    for b in ("ref", "jnp", "pallas", "mega"):
        assert resolve_backend(b) == b


def test_auto_backend_is_mega_on_gpu_and_raises_elsewhere(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert resolve_backend("auto") == "mega"
    monkeypatch.setattr(jax, "default_backend", lambda: "rocm")
    with pytest.raises(RuntimeError, match="no path"):
        resolve_backend("auto")


def test_interpret_never_on_a_gpu(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert pm.resolve_interpret(None) is False
    with pytest.raises(ValueError, match="interpret=True"):
        pm.resolve_interpret(True)


@pytest.mark.parametrize("block", [16, 96, 100])
def test_ray_block_must_be_a_power_of_two(block):
    with pytest.raises(ValueError, match="power of two"):
        pm._tiling(1000, block)


@pytest.mark.parametrize("R,block", [(1, 128), (128, 128), (129, 128),
                                     (1000, 256)])
def test_tiling_pads_to_whole_blocks_with_edge_rays(R, block):
    n, prep, unprep = pm._tiling(R, block)
    assert n == -(-R // block)
    v = jnp.arange(R, dtype=jnp.float32)
    padded = prep(v)
    assert padded.shape == (n * block,)
    np.testing.assert_array_equal(np.asarray(padded[R:]), R - 1)
    np.testing.assert_array_equal(np.asarray(unprep(padded)), np.asarray(v))


def test_warps_follow_the_block():
    assert pm._num_warps(32) == 1
    assert pm._num_warps(128) == 4
    assert pm._num_warps(4096) == 8


def test_round_clip_matches_clip_of_round():
    x = jnp.asarray([-3.0, -1.5, -0.51, -0.5, -0.2, -0.0, 0.0, 0.3, 0.5,
                     0.5001, 1.49, 1.5, 2.5, 7.0], jnp.float32)
    np.testing.assert_array_equal(
        np.asarray(pm._round_clip1(x)),
        np.asarray(jnp.clip(jnp.round(x), -1.0, 1.0)))


# ------------------------------------------------------ compile cache

def test_compile_cache_uses_fixed_checkout_path(monkeypatch):
    from raymarching_tpu.utils import cache
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = cache.setup_compile_cache()
        assert path == str(REPO / ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
        assert ".jax_cache/" in (REPO / ".gitignore").read_text().split()
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_honours_the_environment(monkeypatch, tmp_path):
    from raymarching_tpu.utils import cache
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert cache.setup_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


# ------------------------------------------- entry points need the card

def _run_cpu(args, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("RAYMARCHING_TESTS_ON_DEVICE", None)
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _printed_result(stdout: str) -> bool:
    for line in stdout.splitlines():
        try:
            if "ok" in json.loads(line):
                return True
        except (ValueError, TypeError):
            continue
    return False


def test_chip_smoke_fails_without_a_gpu():
    r = _run_cpu(["chip_smoke.py"], REPO)
    assert r.returncode != 0
    assert not _printed_result(r.stdout)
    assert "no GPU" in r.stderr


def test_chip_smoke_fails_outside_a_checkout(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = _run_cpu(["chip_smoke.py"], tmp_path)
    assert r.returncode != 0
    assert not _printed_result(r.stdout)


def test_bench_fails_without_a_gpu():
    r = _run_cpu(["bench.py"], REPO)
    assert r.returncode != 0
    assert "measures a GPU" in r.stderr
    assert not r.stdout.strip()


# ------------------------------------------------------ on the card

@pytest.mark.gpu
def test_gpu_resolves_to_compiled_kernel_path():
    assert resolve_backend("auto") == "mega"
    assert pm.resolve_interpret(None) is False


@pytest.mark.gpu
def test_gpu_march_kernel_matches_jnp(small_scene):
    from raymarching_tpu.core.march import march_while
    from raymarching_tpu.core.sdf import scene_sd
    plan, tables = small_scene
    o, d = _rays(tables)
    res = pm.pallas_march(pm.kernel_key(plan), 400, 1e-3, BLOCK, o, d,
                          tables)
    ref = march_while(lambda p: scene_sd(plan, tables, p), o, d, 400, 1e-3)
    assert float(jnp.mean(res.converged == ref.converged)) >= 0.99
    both = np.asarray(res.converged & ref.converged)
    np.testing.assert_allclose(np.asarray(res.position)[both],
                               np.asarray(ref.position)[both], atol=1e-3)


@pytest.mark.gpu
def test_gpu_mega_render_matches_ref(small_scene):
    plan, tables = small_scene
    cfg = RenderConfig(width=48, height=32, ssaa=1, iterations=400)
    a = np.asarray(render_tables(plan, tables, cfg, backend="mega"))
    b = np.asarray(render_tables(plan, tables, cfg, backend="ref"))
    diff = np.abs(a - b).max(axis=-1)
    assert (diff <= 1e-3).mean() >= 0.99 and diff.mean() <= 1e-3
