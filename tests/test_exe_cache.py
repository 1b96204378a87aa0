"""AOT executable cache: save/load round-trip and failure modes.

The save-exe/load-exe analog (reference: src/ipu_utils.hpp:30-55,
232-255,483-521) - compiled programs must reload without recompiling,
reject empty manifests, and fall back to JIT when a loaded program's
avals no longer match.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ipu_path_trace_tpu.runtime.exe_cache import ProgramManager


def _fn(x, y):
    return x * 2.0 + y


def test_save_load_roundtrip(tmp_path):
    pm = ProgramManager()
    pm.add("double_add", jax.jit(_fn))
    x = jnp.arange(8.0)
    y = jnp.ones((8,))
    prefix = str(tmp_path / "exe")
    pm.save(prefix, {"double_add": (x, y)})

    pm2 = ProgramManager()
    pm2.add("double_add", jax.jit(_fn))
    assert pm2.load(prefix)
    out = pm2.run("double_add", x, y)
    np.testing.assert_allclose(np.asarray(out), np.asarray(x) * 2 + 1)
    # The loaded program (not the jitted fallback) served the call:
    assert "double_add" in pm2._loaded


def test_load_rejects_missing_and_empty_manifest(tmp_path):
    pm = ProgramManager()
    assert not pm.load(str(tmp_path / "nope"))
    empty = tmp_path / "empty"
    (tmp_path / "empty.json").write_text(json.dumps({"programs": {}}))
    assert not pm.load(str(empty))


def test_save_load_sharded_step(tmp_path):
    """AOT export of the FULL sharded render step (shard_map over a mesh)
    must round-trip - otherwise --save-exe with --ipus N dies after an
    expensive multi-chip compile (make_step_fn, parallel/mesh.py)."""
    from ipu_path_trace_tpu.core.records import make_worklist, to_device_batch
    from ipu_path_trace_tpu.core.scene import default_scene
    from ipu_path_trace_tpu.models.envlight import ConstantEnv
    from ipu_path_trace_tpu.parallel.mesh import make_mesh, make_step_fn, replicate, shard_work
    from ipu_path_trace_tpu.render.params import RenderSettings, StaticConfig

    mesh = make_mesh(8, "4x2")
    cfg = StaticConfig(width=16, height=16)
    scene = replicate(default_scene(), mesh)
    env = replicate(ConstantEnv(colour=jnp.asarray([1.0, 1.0, 1.0])), mesh)
    work = shard_work(to_device_batch(make_worklist(16, 16)), mesh)
    settings = RenderSettings.make(samples_per_step=2)
    # Raw key words: typed-key args break exported shard_map programs
    # at call time (make_step_fn docstring).
    key = jax.random.key_data(jax.random.key(0))
    args = (scene, settings, work, key, env)

    pm = ProgramManager()
    pm.add("render_step", make_step_fn(cfg, mesh))
    prefix = str(tmp_path / "exe")
    pm.save(prefix, {"render_step": args})

    pm2 = ProgramManager()
    pm2.add("render_step", make_step_fn(cfg, mesh))
    assert pm2.load(prefix)
    out = pm2.run("render_step", *args)
    assert "render_step" in pm2._loaded  # served by the AOT program
    assert (np.asarray(out.sample_count) == 4).all()  # 2 local x 2 replicas
    expect = make_step_fn(cfg, mesh)(*args)
    np.testing.assert_array_equal(np.asarray(out.r), np.asarray(expect.r))


def test_aval_mismatch_falls_back_to_jit(tmp_path):
    pm = ProgramManager()
    pm.add("double_add", jax.jit(_fn))
    prefix = str(tmp_path / "exe")
    pm.save(prefix, {"double_add": (jnp.arange(8.0), jnp.ones((8,)))})

    pm2 = ProgramManager()
    pm2.add("double_add", jax.jit(_fn))
    assert pm2.load(prefix)
    # Different shape than the exported specialisation -> JIT fallback:
    x = jnp.arange(16.0)
    out = pm2.run("double_add", x, jnp.ones((16,)))
    np.testing.assert_allclose(np.asarray(out), np.asarray(x) * 2 + 1)
    assert "double_add" not in pm2._loaded  # evicted after rejection


def test_duplicate_program_name_rejected():
    pm = ProgramManager()
    pm.add("p", jax.jit(_fn))
    with pytest.raises(ValueError):
        pm.add("p", jax.jit(_fn))


@pytest.mark.parametrize("env_dir,cache_dir,want", [
    ("/env/cache", "", "/env/cache"),
    ("/env/cache", "/flag/cache", "/env/cache"),  # the flag is ignored
    ("", "/flag/cache", "/flag/cache"),
    ("", "", None),  # the fixed <repo>/.jax_cache
])
def test_compilation_cache_dir_rule(monkeypatch, env_dir, cache_dir, want):
    """JAX_COMPILATION_CACHE_DIR wins, then --cache-dir, then the fixed
    <repo>/.jax_cache - never a temporary or per-process path."""
    import os

    from ipu_path_trace_tpu.runtime import exe_cache

    if env_dir:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env_dir)
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    got = exe_cache.compilation_cache_dir(cache_dir)
    if want is None:
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        assert got == os.path.join(repo, ".jax_cache")
    else:
        assert got == want


def test_cpu_compiles_are_not_cached(monkeypatch, tmp_path):
    from ipu_path_trace_tpu.runtime.exe_cache import enable_compilation_cache

    before = jax.config.jax_compilation_cache_dir
    assert enable_compilation_cache(str(tmp_path / "c")) == ""
    assert jax.config.jax_compilation_cache_dir == before
    assert not (tmp_path / "c").exists()
