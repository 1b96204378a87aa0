"""bench.py's device rules and its profiler-trace split (CPU side)."""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent


def _bench():
    spec = importlib.util.spec_from_file_location("bench", REPO / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_peak_of_known_card():
    assert _bench().peak_bf16_flops("NVIDIA H100 80GB HBM3") == 989e12


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA H100 PCIe", "NVIDIA A100-SXM4-80GB"])
def test_unknown_device_kind_is_error(kind):
    with pytest.raises(ValueError, match="no bf16 peak"):
        _bench().peak_bf16_flops(kind)


def test_require_gpu_refuses_cpu():
    with pytest.raises(RuntimeError, match="needs a GPU"):
        _bench().require_gpu()


def test_trace_split_finds_named_scopes(tmp_path):
    """A profiled step attributes device time to both named scopes of
    render/wavefront.trace_one_sample."""
    from ipu_path_trace_tpu.core.records import make_worklist, to_device_batch
    from ipu_path_trace_tpu.core.scene import default_scene
    from ipu_path_trace_tpu.models.envlight import NifEnv
    from ipu_path_trace_tpu.models.nif import make_params, make_synthetic_nif
    from ipu_path_trace_tpu.render.params import RenderSettings, StaticConfig
    from ipu_path_trace_tpu.render.wavefront import make_base_key, render_step

    bench = _bench()
    weights, meta = make_synthetic_nif(key=0, hidden=32, num_hidden=2,
                                       skip_layer=1)
    env = NifEnv(params=make_params(weights, meta, jnp.bfloat16))
    scene, cfg = default_scene(), StaticConfig(width=16, height=16)
    settings = RenderSettings.make(samples_per_step=2)
    work = to_device_batch(make_worklist(16, 16))
    compiled = bench.compile_for_trace(
        render_step.lower(scene, settings, cfg, work, make_base_key(0), env))
    text = compiled.as_text()
    scopes = bench.op_scopes(text)
    assert {"trace", "env_light"} <= set(scopes.values())
    split = bench.trace_split(compiled, (scene, settings, work,
                                         make_base_key(1), env),
                              str(tmp_path / "trace"), text)
    assert split["ns"].get("trace", 0) > 0
    assert split["ns"].get("env_light", 0) > 0
    assert split["window_ns"] > 0
