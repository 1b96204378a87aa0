"""Golden parity: the wavefront renderer vs the NumPy oracle.

Both consume identical counter-derived random streams, so images must
agree to float32 rounding - the strongest possible check that the
wavefront restructuring preserved the reference's render math
(cf. SURVEY.md section 4: CPU reference renderer as oracle).
"""

import numpy as np
import jax
import jax.numpy as jnp

from ipu_path_trace_tpu.core import default_scene
from ipu_path_trace_tpu.core.records import make_worklist, to_device_batch
from ipu_path_trace_tpu.cpu import oracle_scene_from, render_oracle, trace_sample_oracle
from ipu_path_trace_tpu.models import ConstantEnv, NifEnv, TextureEnv
from ipu_path_trace_tpu.models.nif import make_params, make_synthetic_nif
from ipu_path_trace_tpu.render import RenderSettings, StaticConfig
from ipu_path_trace_tpu.render.wavefront import (
    bounce_uniforms,
    render_step,
    sample_key,
)

W = H = 24
SETTINGS = dict(
    fov=np.float32(np.pi / 2),
    aa_scale=np.float32(0.3),
    azimuth=np.float32(0.25),
    refractive_index=np.float32(1.5),
    stop_prob=np.float32(0.3),
    roulette_depth=3,
    max_path_length=10,
)


def _jax_streams(base_key, sample_idx, n, max_path_length, noise_type="normal"):
    """Extract the renderer's random streams for oracle replay."""
    from ipu_path_trace_tpu.core.camera import aa_noise
    from ipu_path_trace_tpu.render.wavefront import AA_TAG

    skey = sample_key(base_key, sample_idx)
    aa = np.asarray(aa_noise(jax.random.fold_in(skey, AA_TAG), (2, n), noise_type))
    uniforms = np.stack(
        [np.asarray(bounce_uniforms(skey, b, n)) for b in range(max_path_length)]
    )
    return aa, uniforms


def _run_pair(env_jax, env_oracle, spp=4, seed=7, scene=None):
    scene = default_scene() if scene is None else scene
    oscene = oracle_scene_from(scene)
    cfg = StaticConfig(width=W, height=H, max_path_length=10)
    settings = RenderSettings(
        fov=jnp.float32(SETTINGS["fov"]),
        aa_scale=jnp.float32(SETTINGS["aa_scale"]),
        azimuth=jnp.float32(SETTINGS["azimuth"]),
        refractive_index=jnp.float32(SETTINGS["refractive_index"]),
        stop_prob=jnp.float32(SETTINGS["stop_prob"]),
        roulette_depth=jnp.int32(SETTINGS["roulette_depth"]),
        samples_per_step=jnp.int32(spp),
        aperture=jnp.float32(0.0),
        focal_distance=jnp.float32(1.0),
    )
    wl = make_worklist(W, H)
    work = to_device_batch(wl)
    key = jax.random.key(seed)

    out = render_step(scene, settings, cfg, work, key, env_jax)
    img_jax = (
        np.stack([np.asarray(out.r), np.asarray(out.g), np.asarray(out.b)], -1) / spp
    ).reshape(H, W, 3)

    img_oracle = render_oracle(
        oscene,
        W,
        H,
        spp,
        env=env_oracle,
        stream_fn=lambda s: _jax_streams(key, s, W * H, 10),
        fov=SETTINGS["fov"],
        aa_scale=SETTINGS["aa_scale"],
        azimuth=SETTINGS["azimuth"],
        refractive_index=SETTINGS["refractive_index"],
        stop_prob=SETTINGS["stop_prob"],
        roulette_depth=SETTINGS["roulette_depth"],
        max_path_length=SETTINGS["max_path_length"],
    )
    return img_jax, img_oracle, out


def _assert_parity(img_jax, img_oracle, *, scale=1.0, max_diverged=0.05, tol=2e-4):
    """Exact-stream parity up to chaotic branch divergence.

    Identical random streams give bitwise-identical control flow except
    where a float32 rounding difference flips a discontinuous branch
    (hit-vs-miss at grazing angles, the 0.4/0.4001 concentric clear-coat
    spheres, Fresnel/roulette thresholds).  Those lanes diverge
    completely, so we require: (a) few diverged lanes, (b) near-exact
    agreement on the rest.
    """
    diff = np.abs(img_jax - img_oracle).max(axis=-1) / scale
    diverged = diff > 1e-2
    frac = float(diverged.mean())
    assert frac < max_diverged, f"diverged fraction {frac}"
    agree_rmse = float(np.sqrt(np.mean(diff[~diverged] ** 2)))
    assert agree_rmse < tol, f"agreeing-lane RMSE {agree_rmse}"


def test_constant_env_parity():
    img_jax, img_oracle, out = _run_pair(
        ConstantEnv(colour=jnp.asarray([1.0, 0.8, 0.6])),
        ("constant", np.asarray([1.0, 0.8, 0.6], np.float32)),
    )
    _assert_parity(img_jax, img_oracle)
    assert img_jax.mean() > 0.01  # scene is actually lit
    # pathLength stats populated:
    assert int(np.asarray(out.path_length).sum()) > 0
    # sampleCount bookkeeping:
    assert (np.asarray(out.sample_count) == 4).all()


def test_emissive_scene_parity():
    """EMIT-path coverage end to end: the default scene has no emissive
    objects, so run the bundled example scene (emissive ball light) under
    a near-black env - any significant radiance is emitted light, and it
    must replay identically through the oracle (codelets.cpp:192-198
    emit semantics)."""
    from ipu_path_trace_tpu.core.scenefile import load_scene

    import os

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    scene = load_scene(os.path.join(repo, "assets/scenes/three_spheres.json"))
    dark = np.asarray([0.01, 0.01, 0.015], np.float32)
    img_jax, img_oracle, out = _run_pair(
        ConstantEnv(colour=jnp.asarray(dark)),
        ("constant", dark),
        scene=scene,
    )
    _assert_parity(img_jax, img_oracle, scale=max(1.0, float(img_oracle.max())))
    assert img_jax.max() > 0.5  # the ball light actually lights the frame


def test_texture_env_parity():
    rng = np.random.default_rng(3)
    tex = (rng.random((32, 64, 3)) * 2.0).astype(np.float32)
    img_jax, img_oracle, _ = _run_pair(
        TextureEnv(texture=jnp.asarray(tex)), ("texture", tex)
    )
    _assert_parity(img_jax, img_oracle)


def test_nif_env_parity():
    weights, meta = make_synthetic_nif(key=5, hidden=64, num_hidden=3, embedding_dim=6)
    # float32 params on both sides for exact comparison:
    params = make_params(weights, meta, dtype=jnp.float32)
    img_jax, img_oracle, _ = _run_pair(
        NifEnv(params=params), ("nif", weights, meta), spp=2
    )
    _assert_parity(img_jax, img_oracle, scale=max(float(img_oracle.max()), 1.0))


def test_diffuse_scene_near_exact():
    """A diffuse-only scene has no Fresnel/clear-coat knife edges, so the
    diverged-lane fraction should be essentially zero (BASELINE config 1:
    diffuse sphere scene vs CPU oracle)."""
    from ipu_path_trace_tpu.core.scene import Material, make_scene

    M = Material
    scene = make_scene(
        spheres=[((-1.0, 0.0, -4.0), 0.8), ((1.2, 0.2, -5.0), 1.0)],
        discs=[((0.0, 1.0, 0.0), (0.0, -1.6, -5.0), 4.0)],
        colours=[(1.5, 0.5, 0.5), (0.5, 1.5, 0.5), (1.0, 1.0, 1.0)],
        emissions=[(0, 0, 0)] * 3,
        materials=[M.DIFFUSE, M.DIFFUSE, M.DIFFUSE],
    )
    oscene = oracle_scene_from(scene)
    cfg = StaticConfig(width=W, height=H, max_path_length=10)
    settings = RenderSettings.make(samples_per_step=4)
    wl = make_worklist(W, H)
    key = jax.random.key(11)
    out = render_step(
        scene, settings, cfg, to_device_batch(wl), key,
        ConstantEnv(colour=jnp.asarray([1.0, 1.0, 1.0])),
    )
    img_jax = (
        np.stack([np.asarray(out.r), np.asarray(out.g), np.asarray(out.b)], -1) / 4
    ).reshape(H, W, 3)
    img_oracle = render_oracle(
        oscene, W, H, 4,
        env=("constant", np.ones(3, np.float32)),
        stream_fn=lambda s: _jax_streams(key, s, W * H, 10),
    )
    diff = np.abs(img_jax - img_oracle).max(axis=-1)
    assert float((diff > 1e-2).mean()) < 0.005, "diffuse scene diverged"
    assert float(np.sqrt(np.mean(np.minimum(diff, 1e-2) ** 2))) < 1e-4


def test_progressive_accumulation_consistency():
    """Two steps of N samples == one step of 2N samples (different keys ok).

    Checks the accumulate bookkeeping (r/g/b sums, sampleCount) that the
    host film divides through (AccumulatedImage.cpp:59-74).
    """
    scene = default_scene()
    env = ConstantEnv(colour=jnp.asarray([1.0, 1.0, 1.0]))
    wl = make_worklist(W, H)
    work = to_device_batch(wl)
    cfg1 = StaticConfig(width=W, height=H)
    s2 = RenderSettings.make(samples_per_step=2)
    key = jax.random.key(0)
    out = render_step(scene, s2, cfg1, work, key, env)
    out = render_step(scene, s2, cfg1, out, jax.random.key(1), env)
    assert (np.asarray(out.sample_count) == 4).all()
    # Mean radiance from 2x2 steps should approximate a single 4-sample step:
    s4 = RenderSettings.make(samples_per_step=4)
    out2 = render_step(scene, s4, cfg1, to_device_batch(wl), key, env)
    m1 = np.asarray(out.r).mean() / 4
    m2 = np.asarray(out2.r).mean() / 4
    assert abs(m1 - m2) / max(m2, 1e-6) < 0.25  # MC noise tolerance


def test_grid_scene_parity():
    """Many-object scenes: 24 objects through the unrolled select chain
    must still replay exactly against the oracle (the reference cannot
    scale its scene without editing codelets.cpp:111-144; --scene users
    here can, so the chain is exercised well past the default 6)."""
    from ipu_path_trace_tpu.core.scene import grid_scene

    scene = grid_scene(23)  # + floor disc = 24 objects, incl. emissives
    assert scene.num_objects == 24
    img_jax, img_oracle, out = _run_pair(
        ConstantEnv(colour=jnp.asarray([0.6, 0.7, 0.9])),
        ("constant", np.asarray([0.6, 0.7, 0.9], np.float32)),
        spp=2,
        scene=scene,
    )
    _assert_parity(img_jax, img_oracle,
                   scale=max(1.0, float(img_oracle.max())))
    assert img_jax.mean() > 0.01


def test_dof_oracle_parity():
    """Thin-lens DoF: the NumPy oracle and the XLA uniforms driver consume
    identical lens noise and must agree to float rounding."""
    from ipu_path_trace_tpu.render.wavefront import trace_sample_with_uniforms

    scene = default_scene()
    oscene = oracle_scene_from(scene)
    cfg = StaticConfig(width=W, height=H, max_path_length=6)
    settings = RenderSettings.make(
        samples_per_step=1, aperture=0.25, focal_distance=3.0
    )
    wl = make_worklist(W, H)
    cols = wl["u"].astype(np.float32)
    rows = wl["v"].astype(np.float32)
    rng = np.random.default_rng(21)
    p = cols.size
    aa = rng.normal(size=(2, p)).astype(np.float32)
    lens = rng.uniform(0, 1, size=(2, p)).astype(np.float32)
    uniforms = rng.uniform(0, 1, size=(6, 4, p)).astype(np.float32)

    state = trace_sample_with_uniforms(
        scene, settings, cfg, jnp.asarray(cols), jnp.asarray(rows),
        jnp.asarray(aa), jnp.asarray(lens), jnp.asarray(uniforms),
    )
    rad_o, plen_o = trace_sample_oracle(
        oscene, cols, rows, W, H,
        fov=float(settings.fov), aa_scale=float(settings.aa_scale),
        azimuth=0.0, refractive_index=1.5, stop_prob=0.3,
        roulette_depth=3, max_path_length=6,
        aa=aa, uniforms=uniforms, env=("constant", np.ones(3, np.float32)),
        lens=lens, aperture=0.25, focal_distance=3.0,
    )
    # Compare pre-env radiance + escape bookkeeping (env applied later in
    # both pipelines; constant env contribution = esc_w here):
    rad = np.stack(
        [np.asarray(state.radiance.x), np.asarray(state.radiance.y),
         np.asarray(state.radiance.z)], -1,
    ) + np.stack(
        [np.asarray(state.esc_w.x), np.asarray(state.esc_w.y),
         np.asarray(state.esc_w.z)], -1,
    )
    diff = np.abs(rad - (rad_o)).max(axis=-1)
    # Knife-edge Fresnel/RR branches may divert a few lanes:
    assert float((diff > 1e-2).mean()) < 0.02
    assert float(np.sqrt(np.mean(np.minimum(diff, 1e-2) ** 2))) < 1e-3
