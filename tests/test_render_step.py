"""render_step bookkeeping: what one step adds to the worklist.

A step of S samples must add exactly the sum of S traced samples - the
radiance sums, S to every sampleCount and each sample's path length to
pathLength (AccumulateContributions, codelets.cpp:294-300) - and a step
of zero samples must change nothing.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from ipu_path_trace_tpu.core.camera import aa_noise
from ipu_path_trace_tpu.core.records import make_worklist, to_device_batch
from ipu_path_trace_tpu.core.scene import default_scene
from ipu_path_trace_tpu.models.envlight import ConstantEnv, NifEnv, TextureEnv
from ipu_path_trace_tpu.models.nif import make_params, make_synthetic_nif
from ipu_path_trace_tpu.render.params import RenderSettings, StaticConfig
from ipu_path_trace_tpu.render.wavefront import (
    draw_aa_jitter,
    render_step,
    sample_key,
    trace_one_sample,
)

W, H = 24, 16


def _env(kind):
    if kind == "constant":
        return ConstantEnv(colour=jnp.asarray([1.0, 0.9, 0.7]))
    if kind == "texture":
        tex = np.random.default_rng(2).random((16, 32, 3)).astype(np.float32)
        return TextureEnv(texture=jnp.asarray(tex))
    weights, meta = make_synthetic_nif(key=4, hidden=32, num_hidden=2,
                                       skip_layer=1)
    return NifEnv(params=make_params(weights, meta, jnp.float32))


@pytest.mark.parametrize("env_kind", ["constant", "nif"])
def test_zero_samples_is_identity(env_kind):
    work = to_device_batch(make_worklist(W, H))
    work = work._replace(r=work.r + 1.5, sample_count=work.sample_count + 3)
    out = render_step(default_scene(), RenderSettings.make(samples_per_step=0),
                      StaticConfig(width=W, height=H), work,
                      jax.random.key(0), _env(env_kind))
    for f in work._fields:
        np.testing.assert_array_equal(np.asarray(getattr(out, f)),
                                      np.asarray(getattr(work, f)), err_msg=f)


@pytest.mark.parametrize("spp", [1, 3])
def test_counts_and_path_length_sums(spp):
    cfg = StaticConfig(width=W, height=H)
    out = render_step(default_scene(), RenderSettings.make(samples_per_step=spp),
                      cfg, to_device_batch(make_worklist(W, H)),
                      jax.random.key(1), _env("constant"))
    assert (np.asarray(out.sample_count) == spp).all()
    # Every sample pushes between 1 and max_path_length events:
    plen = np.asarray(out.path_length)
    assert (plen >= spp).all() and (plen <= spp * cfg.max_path_length).all()


@pytest.mark.parametrize("env_kind", ["constant", "texture", "nif"])
def test_step_equals_sum_of_samples(env_kind):
    """One step of 3 samples == trace_one_sample at sample keys 0..2."""
    scene = default_scene()
    cfg = StaticConfig(width=W, height=H)
    settings = RenderSettings.make(samples_per_step=3)
    env = _env(env_kind)
    work = to_device_batch(make_worklist(W, H))
    key = jax.random.key(5)
    out = render_step(scene, settings, cfg, work, key, env)
    cols = work.u.astype(jnp.float32)
    rows = work.v.astype(jnp.float32)
    rad, plen = np.zeros((3, W * H), np.float32), np.zeros(W * H, np.int64)
    for s in range(3):
        r, p = jax.jit(trace_one_sample, static_argnums=2)(
            scene, settings, cfg, cols, rows, sample_key(key, s), env)
        rad += np.stack([np.asarray(r.x), np.asarray(r.y), np.asarray(r.z)])
        plen += np.asarray(p)
    got = np.stack([np.asarray(out.r), np.asarray(out.g), np.asarray(out.b)])
    np.testing.assert_allclose(got, rad, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(np.asarray(out.path_length), plen)


@pytest.mark.parametrize("noise_type", ["uniform", "normal", "truncated-normal"])
def test_draw_aa_jitter_distribution(noise_type):
    """The sobol sampler's jitter transform draws the distributions of
    core/camera.aa_noise (compared through their first two moments and
    range)."""
    n = 200_000
    u = jax.random.uniform(jax.random.key(0), (2, n), minval=2.0**-24,
                           maxval=1.0)
    a1, a2 = draw_aa_jitter(u[0], u[1], noise_type)
    ref = np.asarray(aa_noise(jax.random.key(1), (2, n), noise_type))
    for a in (np.asarray(a1), np.asarray(a2)):
        assert abs(a.mean() - ref.mean()) < 0.02
        assert abs(a.std() - ref.std()) < 0.02
        assert a.min() >= ref.min() - 0.5 and a.max() <= ref.max() + 0.5
    if noise_type != "normal":  # bounded supports
        bound = 1.0 if noise_type == "uniform" else 3.0
        assert np.abs(np.asarray(a1)).max() <= bound
