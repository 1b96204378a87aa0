"""Scene-size scaling: ms/sample and compile time vs object count.

The intersection chain is statically unrolled over scene objects
(core/geometry.intersect_scene; gather-free by design - CLAUDE.md), so
per-sample cost grows with N and each new object count pays one
recompile.  The reference has exactly one hard-coded scene
(reference: src/codelets/codelets.cpp:111-144) so this axis does not
exist there; for --scene users here it is the first question: how many
objects before tracing dominates the NIF env light?

Measures, per object count (grid_scene spheres + floor disc):
  * compile + first-step seconds (the recompile price), and
  * steady-state ms/sample -> Mpaths/s at 1104x1000
with the trained 192-E16 NIF env through the production render_step.
Run on the card; timings end in block_until_ready.

Usage:  python scripts/scene_scale_bench.py [N ...]   (default 6 12 24 48 96)
"""

from __future__ import annotations

import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

WIDTH, HEIGHT = 1104, 1000
SAMPLES_PER_STEP = 300
MIN_TIMED_SECONDS = 5.0


def measure(num_objects: int, env, work) -> tuple[float, float]:
    """Returns (compile_seconds, ms_per_sample) for a grid scene."""
    import jax

    from ipu_path_trace_tpu.core.scene import grid_scene
    from ipu_path_trace_tpu.render.params import RenderSettings, StaticConfig
    from ipu_path_trace_tpu.render.wavefront import make_base_key, render_step

    scene = grid_scene(num_objects - 1)  # + floor disc = num_objects
    cfg = StaticConfig(width=WIDTH, height=HEIGHT)
    settings = RenderSettings.make(samples_per_step=SAMPLES_PER_STEP)

    t0 = time.monotonic()
    out = jax.block_until_ready(
        render_step(scene, settings, cfg, work, make_base_key(0), env))
    compile_s = time.monotonic() - t0

    t0 = time.monotonic()
    out = jax.block_until_ready(
        render_step(scene, settings, cfg, out, make_base_key(1), env))
    step_s = time.monotonic() - t0
    steps = max(3, int(MIN_TIMED_SECONDS / step_s) + 1)

    t0 = time.monotonic()
    for i in range(steps):
        out = render_step(scene, settings, cfg, out, make_base_key(i + 2), env)
    jax.block_until_ready(out)
    secs = time.monotonic() - t0
    ms_per_sample = secs / steps / SAMPLES_PER_STEP * 1e3
    return compile_s, ms_per_sample


def main() -> int:
    import jax
    import jax.numpy as jnp

    from ipu_path_trace_tpu.core.records import make_worklist, to_device_batch
    from ipu_path_trace_tpu.models.envlight import NifEnv
    from ipu_path_trace_tpu.models.nif import load_nif_assets

    counts = [int(a) for a in sys.argv[1:]] or [6, 12, 24, 48, 96]
    print(f"device: {jax.devices()[0]}", file=sys.stderr)

    params, _m, _w = load_nif_assets(
        os.path.join(REPO, "assets", "nif_w192e16"), jnp.bfloat16)
    env = NifEnv(params=params)
    work = to_device_batch(make_worklist(WIDTH, HEIGHT))

    print(f"{'objects':>8} {'compile_s':>10} {'ms/sample':>10} {'Mpaths/s':>9}")
    for n in counts:
        compile_s, ms = measure(n, env, work)
        mpaths = WIDTH * HEIGHT / ms / 1e3
        print(f"{n:>8} {compile_s:>10.1f} {ms:>10.3f} {mpaths:>9.1f}",
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
