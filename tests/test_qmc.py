"""The Owen-Sobol sampler (--sampler sobol, render/qmc.py).

Three layers of checks:
  * sequence-level: exact (0, m, s)-net stratification properties that
    any correct Owen-scrambled Sobol construction must keep, plus a
    cross-check of the baked direction numbers against scipy's,
  * renderer-level: the wavefront consuming sobol streams replays
    exactly through the NumPy oracle (same injected-noise machinery as
    the prng parity tests),
  * estimator-level: per-lane index continuity - two progressive steps
    ARE the prefix of one bigger step (the property that makes sobol
    compose with checkpoints and restarts).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from ipu_path_trace_tpu.core import default_scene
from ipu_path_trace_tpu.core.records import make_worklist, to_device_batch
from ipu_path_trace_tpu.models import ConstantEnv
from ipu_path_trace_tpu.render import RenderSettings, StaticConfig
from ipu_path_trace_tpu.render import qmc
from ipu_path_trace_tpu.render.wavefront import (
    make_qmc_ctx,
    render_step,
    sample_key,
    sample_noise,
    sobol_dims_used,
)

W = H = 16


def test_net_property_every_dim():
    """256 consecutive Owen-Sobol samples of one pixel hit each of the
    256 length-1/256 intervals exactly once, in every dimension (Owen
    scrambling preserves the (0, m, s)-net property)."""
    n = 256
    idx = jnp.arange(n, dtype=jnp.int32)
    pid = jnp.full((n,), 1234, jnp.int32)
    for key in (0, 42):
        us = qmc.sobol_uniforms(idx, pid, key, range(12))
        for d, u in enumerate(us):
            bins = np.sort(np.floor(np.asarray(u) * n).astype(int))
            assert np.array_equal(bins, np.arange(n)), f"dim {d} key {key}"


def test_2d_stratification_aa_dims():
    """Dims (0, 1) - the AA jitter pair - form a (0, 2)-sequence: every
    16x16 stratum of the unit square holds exactly one of 256 samples."""
    n = 256
    us = qmc.sobol_uniforms(
        jnp.arange(n, dtype=jnp.int32), jnp.full((n,), 7, jnp.int32), 5,
        range(2),
    )
    u0, u1 = np.asarray(us[0]), np.asarray(us[1])
    cells = np.floor(u0 * 16).astype(int) * 16 + np.floor(u1 * 16).astype(int)
    assert np.array_equal(np.sort(cells), np.arange(256))


def test_direction_numbers_match_scipy():
    scipy = pytest.importorskip("scipy")
    from scipy.stats import qmc as sqmc

    from ipu_path_trace_tpu.render._sobol_dirs import DIRS

    sv = np.asarray(sqmc.Sobol(d=8, scramble=False, bits=32)._sv, np.uint64)
    for d in range(8):
        assert tuple(int(v) for v in sv[d]) == DIRS[d][: sv.shape[1]]


def test_pixel_and_key_decorrelation():
    n = 512
    idx = jnp.zeros((n,), jnp.int32)
    us_by_pixel = qmc.sobol_uniforms(
        idx, jnp.arange(n, dtype=jnp.int32), 3, range(1))[0]
    v = np.asarray(us_by_pixel)
    # Sample 0 across pixels looks uniform (index shuffle decorrelates):
    assert 0.4 < v.mean() < 0.6 and v.std() > 0.2
    a = np.asarray(qmc.sobol_uniforms(
        jnp.arange(n, dtype=jnp.int32), idx, 3, range(1))[0])
    b = np.asarray(qmc.sobol_uniforms(
        jnp.arange(n, dtype=jnp.int32), idx, 4, range(1))[0])
    assert not np.allclose(a, b)


def _settings(spp, seed=9):
    return RenderSettings.make(samples_per_step=spp, seed=seed)


def test_sobol_oracle_parity():
    """The wavefront in sobol mode replays exactly through the NumPy
    oracle consuming the identical injected streams."""
    from ipu_path_trace_tpu.cpu import oracle_scene_from, render_oracle

    scene = default_scene()
    spp = 4
    cfg = StaticConfig(width=W, height=H, max_path_length=6,
                       sampler="sobol")
    settings = _settings(spp)
    work = to_device_batch(make_worklist(W, H))
    key = jax.random.key(7)
    env = ConstantEnv(colour=jnp.asarray([1.0, 0.8, 0.6]))
    out = render_step(scene, settings, cfg, work, key, env)
    img = (np.stack([np.asarray(out.r), np.asarray(out.g),
                     np.asarray(out.b)], -1) / spp).reshape(H, W, 3)

    ctx = make_qmc_ctx(work, cfg, settings)
    n = W * H

    def stream_fn(s):
        rows = np.asarray(sample_noise(sample_key(key, s), n, cfg, ctx, s))
        return rows[0:2], rows[4:].reshape(cfg.max_path_length, 4, n)

    img_o = render_oracle(
        oracle_scene_from(scene), W, H, spp,
        env=("constant", np.asarray([1.0, 0.8, 0.6], np.float32)),
        stream_fn=stream_fn,
        fov=float(settings.fov), aa_scale=float(settings.aa_scale),
        azimuth=float(settings.azimuth), refractive_index=1.5,
        stop_prob=0.3, roulette_depth=3, max_path_length=6,
    )
    diff = np.abs(img - img_o).max(axis=-1)
    assert float((diff > 1e-2).mean()) < 0.05
    assert float(np.sqrt(np.mean(np.minimum(diff, 1e-2) ** 2))) < 2e-4


def test_progressive_steps_are_sequence_prefix():
    """Index continuity: two sobol steps of 2 spp accumulate the SAME
    sample set as one 4-spp step (per-lane indices ride sampleCount), so
    the sums agree to float-addition reordering.  This is exactly the
    property that makes sobol compose with checkpoint/resume; prng mode has no analog (independent step keys).

    Exact only at full sobol coverage (sobol_dims >= 4 + 4L): prng-tail
    dims derive from (step key, in-step sample index) and legitimately
    differ between step splits - independent noise either way.
    """
    scene = default_scene()
    env = ConstantEnv(colour=jnp.asarray([0.9, 0.9, 1.0]))
    cfg = StaticConfig(width=W, height=H, max_path_length=2,
                       sampler="sobol")
    work0 = to_device_batch(make_worklist(W, H))
    k1, k2 = jax.random.key(0), jax.random.key(1)

    two = render_step(scene, _settings(2), cfg, work0, k1, env)
    two = render_step(scene, _settings(2), cfg, two, k2, env)
    one = render_step(scene, _settings(4), cfg, work0, k1, env)

    assert (np.asarray(two.sample_count) == 4).all()
    np.testing.assert_allclose(
        np.asarray(two.r), np.asarray(one.r), rtol=0, atol=1e-4)
    np.testing.assert_allclose(
        np.asarray(two.b), np.asarray(one.b), rtol=0, atol=1e-4)


def test_sobol_mean_matches_prng_ground_truth():
    """Unbiasedness: the sobol estimator's 64-spp frame mean matches a
    1024-spp prng reference within tight MC bounds on a diffuse scene
    (smooth integrand - also where sobol's variance should be LOWER
    than prng's at equal spp)."""
    from ipu_path_trace_tpu.core.scene import Material, make_scene

    M = Material
    scene = make_scene(
        spheres=[((-1.0, 0.0, -4.0), 0.8), ((1.2, 0.2, -5.0), 1.0)],
        discs=[((0.0, 1.0, 0.0), (0.0, -1.6, -5.0), 4.0)],
        colours=[(1.5, 0.5, 0.5), (0.5, 1.5, 0.5), (1.0, 1.0, 1.0)],
        emissions=[(0, 0, 0)] * 3,
        materials=[M.DIFFUSE] * 3,
    )
    env = ConstantEnv(colour=jnp.asarray([1.0, 1.0, 1.0]))
    work = to_device_batch(make_worklist(W, H))
    cfg_s = StaticConfig(width=W, height=H, max_path_length=6,
                         sampler="sobol")
    cfg_p = StaticConfig(width=W, height=H, max_path_length=6)
    out_s = render_step(scene, _settings(64), cfg_s, work, jax.random.key(2), env)
    ref = render_step(scene, _settings(1024), cfg_p, work, jax.random.key(3), env)
    ms = float(np.asarray(out_s.r).mean()) / 64
    mr = float(np.asarray(ref.r).mean()) / 1024
    assert abs(ms - mr) / mr < 0.02, (ms, mr)

    # And equal-spp RMSE should favour sobol on this smooth scene:
    out_p = render_step(scene, _settings(64), cfg_p, work, jax.random.key(2), env)
    img = lambda o, n: np.asarray(o.r) / n
    rmse_s = float(np.sqrt(np.mean((img(out_s, 64) - img(ref, 1024)) ** 2)))
    rmse_p = float(np.sqrt(np.mean((img(out_p, 64) - img(ref, 1024)) ** 2)))
    assert rmse_s < rmse_p, (rmse_s, rmse_p)


def test_cli_sobol_end_to_end(tmp_path):
    """--sampler sobol through the real CLI on the CPU backend:
    deterministic (two runs bitwise-equal) and a genuinely different
    estimator stream from prng."""
    from ipu_path_trace_tpu.film.imageio import read_exr
    from ipu_path_trace_tpu.runtime.cli import main

    common = ["--assets", "constant:0.9,0.8,0.7", "-w", "16", "-H", "16",
              "-s", "4", "--samples-per-step", "2", "--model"]
    assert main(common + ["--sampler", "sobol",
                          "-o", str(tmp_path / "s1.png")]) == 0
    assert main(common + ["--sampler", "sobol",
                          "-o", str(tmp_path / "s2.png")]) == 0
    assert main(common + ["-o", str(tmp_path / "p.png")]) == 0
    s1 = read_exr(str(tmp_path / "s1.exr"))
    np.testing.assert_array_equal(s1, read_exr(str(tmp_path / "s2.exr")))
    assert not np.array_equal(s1, read_exr(str(tmp_path / "p.exr")))


def test_sobol_checkpoint_resume_bitwise(tmp_path):
    """Checkpoint/resume under --sampler sobol stays bitwise-exact (the
    per-lane sequence index rides the worklist sampleCount), and a
    resume under a DIFFERENT sampler is rejected by the fingerprint."""
    import pytest

    from ipu_path_trace_tpu.film.imageio import read_exr
    from ipu_path_trace_tpu.runtime.cli import main

    common = ["--assets", "constant:0.9,0.8,0.7", "-w", "16", "-H", "16",
              "--samples-per-step", "2", "--model", "--sampler", "sobol"]
    ck = str(tmp_path / "state.npz")
    assert main(common + ["-s", "8", "-o", str(tmp_path / "full.png")]) == 0
    assert main(common + ["-s", "4", "--checkpoint", ck,
                          "-o", str(tmp_path / "half.png")]) == 0
    assert main(common + ["-s", "8", "--resume", ck,
                          "-o", str(tmp_path / "res.png")]) == 0
    np.testing.assert_array_equal(
        read_exr(str(tmp_path / "res.exr")), read_exr(str(tmp_path / "full.exr")))
    rc = main(["--assets", "constant:0.9,0.8,0.7", "-w", "16", "-H", "16",
               "--samples-per-step", "2", "--model", "-s", "8",
               "--resume", ck, "-o", str(tmp_path / "bad.png")])
    assert rc != 0  # prng resume of a sobol checkpoint must fail


def test_sobol_dims_used_clamps():
    cfg = StaticConfig(sampler="sobol", sobol_dims=999, max_path_length=3)
    assert sobol_dims_used(cfg) == 16
    cfg = StaticConfig(sampler="sobol", sobol_dims=13, max_path_length=10)
    assert sobol_dims_used(cfg) == 12  # whole bounces only
    cfg = StaticConfig(sampler="prng")
    assert sobol_dims_used(cfg) == 0
