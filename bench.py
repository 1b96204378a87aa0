"""Headline benchmark: Mpaths/s on one card at 1104x1000 with the NIF env light.

The canonical demo config of the reference (1104x1000, 300 samples per
step - reference: README.md:82) rendered on one card.  A "path" is one
camera sample (the reference's samples/sec metric,
src/PathTracerApp.cpp:766-770).  The headline NIF is the canonical 6x320
architecture (the reference's urban_alley-class NIF, README.md:96),
loaded from the on-class asset assets/urban_alley_synth_nif; the
narrower 192-E16 asset is timed too, as a second speed point.

The step is timed over a >= MIN_TIMED_SECONDS window that ends in
``block_until_ready``; compilation is reported separately.  ``mfu`` is
the NIF chain's model FLOPs (analyse_nif) per second over the card's
dense bf16 peak, from PEAK_BF16_FLOPS - an unknown device is an error,
and so is a run without a GPU.

Prints the card's name and power limit on stderr and ONE json line on
stdout:
  {"metric": ..., "value": N, "unit": "Mpaths/s", "device": {...}, ...}

The module also holds the profiler-trace split (trace_split), which
attributes device time to the step's named scopes (render/wavefront.py).
"""

from __future__ import annotations

import collections
import glob
import json
import os
import re
import subprocess
import sys
import time

import jax

WIDTH, HEIGHT = 1104, 1000
SAMPLES_PER_STEP = 300  # canonical demo step size (reference README.md:82)
MIN_TIMED_SECONDS = 10.0
REPO = os.path.dirname(os.path.abspath(__file__))
CANONICAL_ASSET = os.path.join(REPO, "assets", "urban_alley_synth_nif")

# Dense bf16 tensor peak per device_kind, without sparsity (NVIDIA H100
# SXM data sheet).
PEAK_BF16_FLOPS = {"NVIDIA H100 80GB HBM3": 989e12}


def peak_bf16_flops(device_kind: str) -> float:
    """Dense bf16 peak of a known card; any other device is an error."""
    if device_kind not in PEAK_BF16_FLOPS:
        raise ValueError(f"no bf16 peak on record for device kind "
                         f"{device_kind!r} (known: {sorted(PEAK_BF16_FLOPS)})")
    return PEAK_BF16_FLOPS[device_kind]


def require_gpu():
    """The first device, which must be a GPU: a benchmark that finds no
    card fails instead of timing the CPU."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise RuntimeError(f"needs a GPU, found platform {dev.platform!r}")
    return dev


def card_info() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def load_env(asset_dir: str):
    """(NifEnv, analyse_nif info) of a shipped asset, bf16 params."""
    import jax.numpy as jnp

    from ipu_path_trace_tpu.models.envlight import NifEnv
    from ipu_path_trace_tpu.models.nif import analyse_nif, load_nif_assets

    params, _, weights = load_nif_assets(asset_dir, jnp.bfloat16)
    return NifEnv(params=params), analyse_nif(weights, 1)


def canonical_inputs():
    """(scene, cfg, settings, work) of the canonical frame, in the app's
    default coherent layout (runtime/worklist.coherent_order)."""
    from ipu_path_trace_tpu.core.records import make_worklist, to_device_batch
    from ipu_path_trace_tpu.core.scene import default_scene
    from ipu_path_trace_tpu.render.params import RenderSettings, StaticConfig
    from ipu_path_trace_tpu.runtime.worklist import coherent_order

    scene = default_scene()
    cfg = StaticConfig(width=WIDTH, height=HEIGHT)
    settings = RenderSettings.make(samples_per_step=SAMPLES_PER_STEP)
    work = to_device_batch(coherent_order(make_worklist(WIDTH, HEIGHT), scene,
                                          WIDTH, HEIGHT, 90.0))
    return scene, cfg, settings, work


def measure(label: str, env, scene, cfg, settings, work) -> dict:
    """Compile time and steady-state Mpaths/s of render_step."""
    from ipu_path_trace_tpu.render.wavefront import make_base_key, render_step

    t0 = time.monotonic()
    compiled = render_step.lower(scene, settings, cfg, work,
                                 make_base_key(0), env).compile()
    compile_s = time.monotonic() - t0
    out = jax.block_until_ready(compiled(scene, settings, work,
                                         make_base_key(0), env))
    t0 = time.monotonic()
    out = jax.block_until_ready(compiled(scene, settings, out,
                                         make_base_key(1), env))
    step_s = time.monotonic() - t0
    timed_steps = max(3, int(MIN_TIMED_SECONDS / step_s) + 1)
    t0 = time.monotonic()
    for i in range(timed_steps):
        out = compiled(scene, settings, out, make_base_key(i + 2), env)
    jax.block_until_ready(out)
    secs = time.monotonic() - t0
    paths = WIDTH * HEIGHT * int(settings.samples_per_step)
    mpaths = paths * timed_steps / secs / 1e6
    print(f"[{label}] compile {compile_s:.2f}s; {timed_steps} steps in "
          f"{secs:.2f}s -> {mpaths:.2f} Mpaths/s", file=sys.stderr)
    return {"compile_s": compile_s, "mpaths_per_s": mpaths,
            "step_s": secs / timed_steps, "timed_steps": timed_steps,
            "compiled": compiled}


# --------------------------------------------------------------------------
# Profiler-trace split
# --------------------------------------------------------------------------

# Named scopes of the render step (render/wavefront.trace_one_sample),
# in the order they are tested against an op's scope path:
SCOPES = ("env_light", "trace")
_HLO_OP = re.compile(
    r'^\s*(?:ROOT\s+)?%?([\w.\-]+) = .*?metadata=\{[^}]*op_name="([^"]*)"')
LIBRARY = "__library__"  # key of the scope that library kernels belong to


def _kernel_name(instruction: str) -> str:
    """XLA:GPU names a fusion's kernel after its instruction, with '.'
    and '-' turned into '_' (loop_convert_fusion.4 ->
    loop_convert_fusion_4)."""
    return instruction.replace(".", "_").replace("-", "_")


def op_scopes(hlo_text: str) -> dict[str, str]:
    """Kernel name -> named scope (one of SCOPES, or "other"), read from
    the op_name metadata of the compiled module's text.

    Library kernels (cuBLAS GEMMs) carry the library's own names, so
    they cannot be matched one by one; when every library call of the
    module has the same scope, entry LIBRARY holds it.
    """
    out, library = {}, set()
    for line in hlo_text.splitlines():
        m = _HLO_OP.match(line)
        if m:
            parts = m.group(2).split("/")
            scope = next((s for s in SCOPES if s in parts), "other")
            out[_kernel_name(m.group(1))] = scope
            if 'custom_call_target="__cublas' in line:
                library.add(scope)
    if len(library) == 1:
        out[LIBRARY] = library.pop()
    return out


def reduce_trace(xplane_path: str, hlo_text: str) -> dict:
    """Device time per named scope (ns) from a profiler trace.

    Sums the durations of the device events (on a CPU-only run, the
    host's XLA events) of the compiled step's module, by kernel name;
    also returns the busy window's length and the ten costliest
    kernels.  Events of other modules are counted apart under
    "outside", kernels of no instruction (library GEMMs) under the
    scope op_scopes found for them, else "library".
    """
    scopes = op_scopes(hlo_text)
    module = re.match(r"HloModule ([^\s,]+)", hlo_text).group(1)
    pd = jax.profiler.ProfileData.from_file(xplane_path)
    planes = ([p for p in pd.planes if p.name.startswith("/device:")]
              or [p for p in pd.planes if p.name == "/host:CPU"])
    by_scope = collections.Counter()
    by_op = collections.Counter()
    start, end = None, None
    for plane in planes:
        for line in plane.lines:
            for ev in line.events:
                stats = dict(ev.stats)
                if str(stats.get("hlo_module")) != module:
                    scope = "outside"
                else:
                    scope = scopes.get(_kernel_name(ev.name)) or scopes.get(
                        LIBRARY, "library")
                by_scope[scope] += ev.duration_ns
                if scope != "outside":
                    by_op[ev.name] += ev.duration_ns
                    start = ev.start_ns if start is None else min(start, ev.start_ns)
                    end = max(end or 0, ev.start_ns + ev.duration_ns)
    return {"ns": dict(by_scope),
            "window_ns": (end - start) if start is not None else 0,
            "top_ops": by_op.most_common(10)}


def compile_for_trace(lowered):
    """Compile ``lowered`` so that its op names are this build's.

    The persistent compile cache's key ignores debug metadata, so a
    cached executable carries the named scopes of whichever build first
    compiled the same program.  An extra compiler option (embedding the
    HLO in the executable, which changes no generated code) gives the
    trace its own cache key.
    """
    return lowered.compile(compiler_options={"xla_embed_ir_in_executable": True})


def trace_split(fn, args, trace_dir: str, hlo_text: str) -> dict:
    """Profile one call of ``fn(*args)`` (already compiled) and reduce
    the trace to device time per named scope."""
    jax.profiler.start_trace(trace_dir)
    try:
        jax.block_until_ready(fn(*args))
    finally:
        jax.profiler.stop_trace()
    paths = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                             recursive=True), key=os.path.getmtime)
    if not paths:
        raise RuntimeError(f"no profiler trace written under {trace_dir}")
    return reduce_trace(paths[-1], hlo_text)


def main() -> None:
    dev = require_gpu()
    peak = peak_bf16_flops(dev.device_kind)
    print(f"bench card: {card_info()}", file=sys.stderr)
    from ipu_path_trace_tpu.runtime.exe_cache import enable_compilation_cache

    enable_compilation_cache()
    scene, cfg, settings, work = canonical_inputs()
    env, info = load_env(CANONICAL_ASSET)
    canon = measure("canonical 6x320", env, scene, cfg, settings, work)
    env_192, _ = load_env(os.path.join(REPO, "assets", "nif_w192e16"))
    rate_192 = measure("192-E16", env_192, scene, cfg, settings,
                       work)["mpaths_per_s"]
    flops_per_sample = float(info["flops"]) * WIDTH * HEIGHT
    mfu = float(info["flops"]) * canon["mpaths_per_s"] * 1e6 / peak
    print(f"mfu={mfu:.4f} (NIF model flops over {peak / 1e12:.0f} TFLOP/s "
          f"bf16, {dev.device_kind})", file=sys.stderr)
    print(json.dumps({
        "metric": "Mpaths/sec/card at 1104x1000, 300 spp/step, trained "
                  "6x320 NIF env",
        "value": round(canon["mpaths_per_s"], 3),
        "unit": "Mpaths/s",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "compile_s": round(canon["compile_s"], 2),
        "flops_per_sample_model": round(flops_per_sample),
        "mfu": round(mfu, 4),
        "nif_192e16_mpaths": round(rate_192, 3),
    }))


if __name__ == "__main__":
    main()
