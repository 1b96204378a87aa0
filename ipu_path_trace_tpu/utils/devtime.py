"""On-device step timing - the cycle-counter analog.

The reference wraps its path-trace compute set, the NIF exec, and the
whole iteration in device cycle counters streamed back per step
(reference: src/PathTracerApp.cpp:438-462,470-475).  XLA offers no
in-program cycle counter, so ``--device-timing`` times the whole step:
``loop`` samples run inside one jitted dispatch (so per-dispatch host
latency amortises away) and the clock stops at ``block_until_ready``.
The split between the trace and the NIF comes from a profiler trace
(``--profile-dir``, or bench.py's trace split), whose device events
carry the step's named scopes (render/wavefront.py).
"""

from __future__ import annotations

import time

import jax
import jax.numpy as jnp

from .logging import logger


def measure_step(scene, settings, cfg, work, step_key, env, mesh=None,
                 loop: int = 300, reps: int = 2) -> dict[str, float]:
    """Per-sample device time of the whole render step at the given
    shapes: {"step_ms", "mpaths_per_sec", "mpaths_per_sec_chip"}.

    Meshes are supported: the sharded step is timed and the rate is
    also reported per chip.
    """
    from ..render.wavefront import render_step

    n_pixels = int(work.u.shape[0])
    # Paths per dispatched sample: a samples mesh axis renders the same
    # pixels on every replica (combined spp = per-chip spp * axis size,
    # parallel/mesh.sharded_render_step):
    sample_replicas = mesh.shape["samples"] if mesh is not None else 1
    loop_settings = settings._replace(samples_per_step=jnp.int32(loop))
    if mesh is not None:
        from ..parallel.mesh import replicate, shard_work, sharded_render_step

        work = shard_work(work, mesh)
        loop_settings = replicate(loop_settings, mesh)
        n_chips = mesh.devices.size

        def step():
            return sharded_render_step(
                scene, loop_settings, cfg, work, step_key, env, mesh)
    else:
        n_chips = 1

        def step():
            return render_step(scene, loop_settings, cfg, work, step_key, env)

    jax.block_until_ready(step())  # compile + warm-up
    t0 = time.monotonic()
    for _ in range(reps):
        out = step()
    jax.block_until_ready(out)
    step_s = (time.monotonic() - t0) / reps / loop
    mpaths = n_pixels * sample_replicas / step_s / 1e6
    return {"step_ms": step_s * 1e3, "mpaths_per_sec": mpaths,
            "mpaths_per_sec_chip": mpaths / n_chips}


def log_step_timing(timing: dict[str, float]) -> None:
    """Log the measured step time (the per-step cycle-count analog)."""
    msg = (f"step={timing['step_ms']:.2f}ms/sample "
           f"({timing['mpaths_per_sec']:.1f} Mpaths/s")
    if timing["mpaths_per_sec_chip"] != timing["mpaths_per_sec"]:
        msg += f" = {timing['mpaths_per_sec_chip']:.1f}/chip"
    logger().info("Device step timing: %s)", msg)
