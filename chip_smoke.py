"""Smoke test of the renderer on an NVIDIA GPU: the quickest proof that
the system still starts on the card.

    python chip_smoke.py            # phases 1-6 on one card
    python chip_smoke.py --cards 4  # only the four-card mesh phase

Phases (one card):
  1. device: a GPU must be present; prints the card's name and power
     limit and which optional packages import;
  2. canonical render: the reference's demo command through the
     tpu_trace CLI (6x320 NIF, 1104x1000, 300 spp/step), with the
     step's compile time, steady-state Mpaths/s, memory, and a profiler
     trace split into NIF chain / trace / rest;
  3. NIF chain at full width against a float32 NumPy reference;
  4. the wavefront against the NumPy oracle (cpu/oracle.py);
  5. --nif-precision int8, --sampler sobol and --nif-mode baked, one
     step each through the CLI, and the int8 chain on the card against
     the same chain on the CPU;
  6. the card-only test tier (pytest -m gpu).

Everything runs in this one process: a JAX process reserves most of
the card's memory, so a second one would fail.  Outputs (images, the
profiler trace) go to chiprun_out/chip_smoke/.  The last line of stdout
is {"ok": true, "device": {...}} and is printed only when every phase
passed; any failure exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(REPO, "chiprun_out", "chip_smoke")
CANONICAL_ASSET = os.path.join(REPO, "assets", "urban_alley_synth_nif")
INT8_ASSET = os.path.join(REPO, "assets", "urban_alley_synth_nif_int8")
OPTIONAL_PACKAGES = ("h5py", "PIL", "imageio")

# The reference's canonical demo render (its README's command line):
FRAME = ["-w", "1104", "-H", "1000"]
SAMPLING = ["-s", "900", "--samples-per-step", "300", "--save-interval", "3"]


def canonical_argv() -> list[str]:
    return FRAME + SAMPLING + ["--device-film", "--assets", CANONICAL_ASSET]

# Phase 3 bounds on the NIF chain against the float32 NumPy reference.
# float32 params at "highest" matmul precision: max relative error (the
# CPU reaches 3.8e-5 on the canonical asset).  Production bf16 params:
# the CPU measures a median relative error of 1.2e-2 and a 99th
# percentile of 7.2e-2 (bf16 activations, amplified by the exp decode);
# the bounds are twice that.
F32_MAX_REL = 1e-4
BF16_MEDIAN_REL = 2.5e-2
BF16_P99_REL = 1.5e-1

# Phase 4 bounds, wavefront vs oracle on identical random streams.  A
# last-ulp difference (FMA contraction, the card's sin/cos/exp/rsqrt)
# can flip a roulette, Fresnel or hit/miss decision, and that lane's
# path then diverges completely, moving one pixel by O(0.5): at 64x64
# and 4 spp the CPU itself shows 1-7 such pixels and an image-mean
# error of up to 2.3e-4.  So: at least 99% of pixels within 1e-3
# relative (floor 1), and the image mean within 1e-3 relative.
PIXEL_REL = 1e-3
PIXEL_FRACTION = 0.99
MEAN_REL = 1e-3

# Phase 5: the int8 chain on the card vs the CPU.  Integer dots agree
# exactly; the f32 Fourier encode can round a feature to the other int8
# step on either backend, which moves that lane's output.  Bound the
# share of lanes that moved by more than 1e-3 relative.
INT8_MOVED_FRACTION = 0.01


class SmokeError(RuntimeError):
    """A phase's check failed."""


def check_device(devices):
    """The first device, which must be a GPU."""
    dev = devices[0]
    if dev.platform != "gpu":
        raise SmokeError(f"no GPU: JAX's first device is on platform "
                         f"{dev.platform!r}")
    return dev


def last_line(platform: str, kind: str, count: int) -> str:
    """The result line the script ends with."""
    return json.dumps({"ok": True, "device": {
        "platform": platform, "kind": kind, "count": count}})


def optional_imports() -> dict[str, bool]:
    """Which optional packages import (none is on the render path)."""
    found = {}
    for name in OPTIONAL_PACKAGES:
        try:
            __import__(name)
            found[name] = True
        except ImportError:
            found[name] = False
    return found


def card_info() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def run_cli(argv: list[str]) -> float:
    """Run the tpu_trace CLI in this process; returns its wall time."""
    from ipu_path_trace_tpu.runtime.cli import main as cli_main

    t0 = time.monotonic()
    rc = cli_main(argv)
    if rc != 0:
        raise SmokeError(f"tpu_trace {' '.join(argv)} exited {rc}")
    return time.monotonic() - t0


def check_image(png: str) -> None:
    """PNG and EXR exist, are finite, and are not constant."""
    from ipu_path_trace_tpu.film.imageio import read_exr, read_png

    ldr = read_png(png)
    hdr = read_exr(os.path.splitext(png)[0] + ".exr")
    if not np.isfinite(hdr).all():
        raise SmokeError(f"{png}: non-finite HDR values")
    if ldr.min() == ldr.max() or hdr.min() == hdr.max():
        raise SmokeError(f"{png}: constant image")
    print(f"  {os.path.basename(png)}: {ldr.shape}, HDR mean "
          f"{hdr.mean():.5g}, max {hdr.max():.5g}")


def uv_lattice(n: int = 256):
    g = ((np.arange(n) + 0.5) / n).astype(np.float32)
    u, v = np.meshgrid(g, g, indexing="ij")
    return u.ravel(), v.ravel()


def rel_err(out, ref):
    return np.abs(out - ref) / np.maximum(np.abs(ref), 1e-30)


# --------------------------------------------------------------------------
# Phases
# --------------------------------------------------------------------------


def phase_canonical_render() -> None:
    import jax

    import bench

    from ipu_path_trace_tpu.core.records import make_worklist, to_device_batch
    from ipu_path_trace_tpu.runtime.exe_cache import compilation_cache_dir

    scene, cfg, settings, work = bench.canonical_inputs()
    env, info = bench.load_env(CANONICAL_ASSET)
    cache = compilation_cache_dir()
    before = len(os.listdir(cache)) if os.path.isdir(cache) else 0
    m = bench.measure("canonical 6x320", env, scene, cfg, settings, work)
    after = len(os.listdir(cache)) if os.path.isdir(cache) else 0
    print(f"  persistent compile cache {cache}: {before} entries before the "
          f"compile, {after} after (a new entry means a cold compile)")
    compiled = m["compiled"]
    ma = compiled.memory_analysis()
    print(f"  step compile {m['compile_s']:.2f} s; steady state "
          f"{m['mpaths_per_s']:.3f} Mpaths/s ({m['step_s'] * 1e3:.1f} ms per "
          f"300-spp step, {m['timed_steps']} steps)")
    print(f"  memory_analysis: temp {ma.temp_size_in_bytes / 2**20:.0f} MiB, "
          f"arguments {ma.argument_size_in_bytes / 2**20:.0f} MiB, outputs "
          f"{ma.output_size_in_bytes / 2**20:.0f} MiB")
    stats = jax.devices()[0].memory_stats() or {}
    print(f"  peak_bytes_in_use {stats.get('peak_bytes_in_use', 0) / 2**30:.3f} GiB")
    mfu = info["flops"] * m["mpaths_per_s"] * 1e6 / bench.peak_bf16_flops(
        jax.devices()[0].device_kind)
    print(f"  NIF model FLOP/s over the bf16 peak: {mfu:.4f}")
    raster = bench.measure("raster layout", env, scene, cfg, settings,
                           to_device_batch(make_worklist(bench.WIDTH,
                                                         bench.HEIGHT)))
    print(f"  raster worklist order instead of the default coherent one: "
          f"{raster['mpaths_per_s']:.3f} Mpaths/s")

    # Profiler trace of one 8-spp step (samples_per_step is a runtime
    # value), split by named scope:
    from ipu_path_trace_tpu.render.wavefront import make_base_key, render_step

    spp = 8
    args = (scene, settings._replace(samples_per_step=np.int32(spp)), work,
            make_base_key(9), env)
    t0 = time.monotonic()
    fresh = bench.compile_for_trace(render_step.lower(
        scene, settings, cfg, work, make_base_key(0), env))
    print(f"  compile for the trace: {time.monotonic() - t0:.2f} s "
          f"(cold unless this program was traced before)")
    hlo = fresh.as_text()
    with open(os.path.join(OUT, "step_hlo.txt"), "w") as f:
        f.write(hlo)
    split = bench.trace_split(fresh, args, os.path.join(OUT, "trace"), hlo)
    ns = split["ns"]
    for scope in ("env_light", "trace", "other", "outside"):
        print(f"  trace split {scope:9s}: {ns.get(scope, 0) / 1e6 / spp:8.3f} "
              f"ms per sample")
    print(f"  busy window {split['window_ns'] / 1e6 / spp:.3f} ms per sample")
    for name, dur in split["top_ops"]:
        print(f"    {dur / 1e6 / spp:8.3f} ms/sample  {name[:90]}")
    if not ns.get("env_light") or not ns.get("trace"):
        raise SmokeError(f"trace split found no NIF or trace time: {ns}")

    png = os.path.join(OUT, "smoke.png")
    secs = run_cli(canonical_argv() + ["-o", png])
    print(f"  tpu_trace canonical render (900 spp): {secs:.2f} s wall")
    check_image(png)


def phase_nif_chain() -> None:
    import jax
    import jax.numpy as jnp

    from ipu_path_trace_tpu.cpu import nif_forward
    from ipu_path_trace_tpu.models.nif import load_nif_assets, make_params, nif_apply

    p16, meta, weights = load_nif_assets(CANONICAL_ASSET, jnp.bfloat16)
    p32 = make_params(weights, meta, jnp.float32)
    u, v = uv_lattice()
    ref = nif_forward(weights, meta, u, v)
    apply = jax.jit(nif_apply)
    with jax.default_matmul_precision("highest"):
        out32 = np.asarray(apply(p32, jnp.asarray(u), jnp.asarray(v)))
    r32 = rel_err(out32, ref)
    out16 = np.asarray(apply(p16, jnp.asarray(u), jnp.asarray(v)))
    r16 = rel_err(out16, ref)
    print(f"  {u.size} lattice points, 6x320: float32/highest max rel "
          f"{r32.max():.3e} (bound {F32_MAX_REL}); bf16 median "
          f"{np.median(r16):.3e} (bound {BF16_MEDIAN_REL}), p99 "
          f"{np.quantile(r16, 0.99):.3e} (bound {BF16_P99_REL}), max "
          f"{r16.max():.3e}")
    if r32.max() > F32_MAX_REL:
        raise SmokeError("float32 NIF chain exceeds its bound")
    if np.median(r16) > BF16_MEDIAN_REL or np.quantile(r16, 0.99) > BF16_P99_REL:
        raise SmokeError("bf16 NIF chain exceeds its bound")


def phase_oracle() -> None:
    import jax
    import jax.numpy as jnp

    from ipu_path_trace_tpu.core.camera import aa_noise
    from ipu_path_trace_tpu.core.records import make_worklist, to_device_batch
    from ipu_path_trace_tpu.core.scene import default_scene
    from ipu_path_trace_tpu.cpu import oracle_scene_from, render_oracle
    from ipu_path_trace_tpu.models.envlight import ConstantEnv, NifEnv, TextureEnv
    from ipu_path_trace_tpu.models.nif import load_nif_assets, make_params
    from ipu_path_trace_tpu.render.params import RenderSettings, StaticConfig
    from ipu_path_trace_tpu.render.wavefront import (
        AA_TAG, bounce_uniforms, make_base_key, render_step, sample_key)

    w = h = 64
    spp, n = 4, 64 * 64
    scene = default_scene()
    cfg = StaticConfig(width=w, height=h)
    settings = RenderSettings.make(samples_per_step=spp)
    work = to_device_batch(make_worklist(w, h))
    key = make_base_key(7, "threefry2x32")

    def streams(s):
        sk = sample_key(key, s)
        aa = np.asarray(aa_noise(jax.random.fold_in(sk, AA_TAG), (2, n),
                                 cfg.aa_noise_type))
        return aa, np.stack([np.asarray(bounce_uniforms(sk, b, n))
                             for b in range(cfg.max_path_length)])

    _, meta, weights = load_nif_assets(CANONICAL_ASSET)
    tex = (np.random.default_rng(3).random((32, 64, 3)) * 2).astype(np.float32)
    colour = np.asarray([1.0, 0.8, 0.6], np.float32)
    envs = {
        "constant": (ConstantEnv(colour=jnp.asarray(colour)), ("constant", colour)),
        "texture": (TextureEnv(texture=jnp.asarray(tex)), ("texture", tex)),
        "nif": (NifEnv(params=make_params(weights, meta, jnp.float32)),
                ("nif", weights, meta)),
    }
    failed = []
    for name, (env, env_oracle) in envs.items():
        with jax.default_matmul_precision("highest"):
            out = render_step(scene, settings, cfg, work, key, env)
        img = np.stack([np.asarray(out.r), np.asarray(out.g),
                        np.asarray(out.b)], -1).reshape(h, w, 3) / spp
        ref = render_oracle(
            oracle_scene_from(scene), w, h, spp, env=env_oracle,
            stream_fn=streams, fov=float(settings.fov),
            aa_scale=float(settings.aa_scale),
            azimuth=float(settings.azimuth))
        err = (np.abs(img - ref) / np.maximum(np.abs(ref), 1.0)).max(axis=-1)
        within = float((err <= PIXEL_REL).mean())
        mean_rel = abs(float(img.mean()) - float(ref.mean())) / float(ref.mean())
        print(f"  {name:8s}: {within * 100:.3f}% of pixels within {PIXEL_REL} "
              f"(bound {PIXEL_FRACTION * 100:.0f}%), image mean rel "
              f"{mean_rel:.3e} (bound {MEAN_REL})")
        if within < PIXEL_FRACTION or mean_rel > MEAN_REL:
            failed.append(name)
    if failed:
        raise SmokeError(f"wavefront disagrees with the oracle: {failed}")


def phase_other_paths() -> None:
    import jax
    import jax.numpy as jnp

    from ipu_path_trace_tpu.models.nif import load_nif_assets
    from ipu_path_trace_tpu.models.quant import nif_apply_quant, quantize_nif

    one_step = FRAME + ["-s", SAMPLING[3], "--samples-per-step", SAMPLING[3],
                        "--device-film"]
    runs = {
        "int8": ["--assets", INT8_ASSET, "--nif-precision", "int8"],
        "sobol": ["--assets", CANONICAL_ASSET, "--sampler", "sobol"],
        "baked": ["--assets", CANONICAL_ASSET, "--nif-mode", "baked"],
    }
    for name, extra in runs.items():
        png = os.path.join(OUT, f"{name}.png")
        secs = run_cli(one_step + extra + ["-o", png])
        print(f"  {name}: one 300-spp step through tpu_trace, {secs:.2f} s wall")
        check_image(png)

    _, meta, weights = load_nif_assets(INT8_ASSET)
    with open(os.path.join(INT8_ASSET, "quant_amax.json")) as f:
        amax = [float(a) for a in json.load(f)["amax"]]
    qp = quantize_nif(weights, meta, amax=amax)
    u, v = uv_lattice()
    on_card = np.asarray(jax.jit(nif_apply_quant)(qp, jnp.asarray(u),
                                                  jnp.asarray(v)))
    cpu = jax.devices("cpu")[0]
    on_cpu = np.asarray(jax.jit(nif_apply_quant)(
        jax.device_put(qp, cpu), jax.device_put(u, cpu),
        jax.device_put(v, cpu)))
    r = rel_err(on_card, on_cpu)
    moved = float((r > 1e-3).mean())
    print(f"  int8 chain card vs CPU: {float((r == 0).mean()) * 100:.2f}% "
          f"bitwise equal, {moved * 100:.3f}% moved > 1e-3 (bound "
          f"{INT8_MOVED_FRACTION * 100:.0f}%), max rel {r.max():.3e}")
    if moved > INT8_MOVED_FRACTION:
        raise SmokeError("int8 chain on the card disagrees with the CPU")


def phase_gpu_tests() -> None:
    import pytest

    # The test configuration forces the CPU unless JAX_PLATFORMS names
    # another platform (tests/conftest.py); this process holds the card.
    os.environ["JAX_PLATFORMS"] = "cuda"
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(REPO, "tests")])
    if rc != 0:
        raise SmokeError(f"pytest -m gpu exited {int(rc)}")


# --------------------------------------------------------------------------
# Four cards
# --------------------------------------------------------------------------


def mesh_replay(argv: list[str], mesh_shape: str, n_devices: int,
                out_dir: str) -> dict:
    """Render ``argv`` through tpu_trace on an ``n_devices`` mesh and
    replay every shard on one device.

    The sharded run writes its final worklist to a --checkpoint.  Each
    pixel shard's slice is then rendered with a single-device
    render_step, step by step, with the key parallel/mesh.local_step
    folds (fold_in(fold_in(step_key, pixel_idx), sample_idx)), summed
    over the samples axis.  Returns the worst deviations.
    """
    import jax
    import jax.numpy as jnp

    from ipu_path_trace_tpu.core.records import WorkBatch
    from ipu_path_trace_tpu.parallel.mesh import parse_mesh_shape
    from ipu_path_trace_tpu.render.wavefront import make_base_key, render_step
    from ipu_path_trace_tpu.runtime.app import PathTracerApp
    from ipu_path_trace_tpu.runtime.cli import parse_config

    tag = mesh_shape.replace("x", "by")
    ckpt = os.path.join(out_dir, f"mesh_{tag}.npz")
    full = argv + ["--ipus", str(n_devices), "--mesh-shape", mesh_shape,
                   "--checkpoint", ckpt,
                   "-o", os.path.join(out_dir, f"mesh_{tag}.png")]
    if os.path.exists(ckpt):
        os.remove(ckpt)
    secs = run_cli(full)
    with np.load(ckpt) as z:
        got = {k[len("soa_"):]: z[k] for k in z.files if k.startswith("soa_")}

    cfg = parse_config(full)
    n_px, n_sm = parse_mesh_shape(mesh_shape, n_devices)
    app = PathTracerApp(cfg)
    app.init()  # loads the env light exactly as the sharded run did
    settings = app.settings(cfg.samples_per_step // n_sm)
    static = app.static_config()
    key = make_base_key(cfg.seed, cfg.rng_impl)
    n = got["u"].shape[0]
    per = n // n_px
    fresh = {k: np.zeros_like(v) for k, v in got.items()}
    fresh["u"], fresh["v"] = got["u"], got["v"]
    steps = cfg.rounded_samples_per_pixel() // cfg.samples_per_step
    parts = []
    for i in range(n_px):
        sl = WorkBatch(**{k: jnp.asarray(v[i * per:(i + 1) * per])
                          for k, v in fresh.items()})
        for step in range(1, steps + 1):
            k_step = jax.random.fold_in(key, step)
            acc = None
            for s in range(n_sm):
                k = jax.random.fold_in(jax.random.fold_in(k_step, i), s)
                o = render_step(app.scene, settings, static, sl, k, app.env)
                d = jax.tree.map(lambda a, b: a - b, o, sl)
                acc = d if acc is None else jax.tree.map(jnp.add, acc, d)
            sl = jax.tree.map(jnp.add, sl, acc)
        parts.append(jax.tree.map(np.asarray, sl))
    want = {f: np.concatenate([getattr(p, f) for p in parts])
            for f in WorkBatch._fields}
    if not np.array_equal(got["sample_count"], want["sample_count"]):
        raise SmokeError(f"{mesh_shape}: sample counts differ from replay")
    if not np.array_equal(got["u"], want["u"]):
        raise SmokeError(f"{mesh_shape}: worklist order differs from replay")
    rgb_got = np.stack([got["r"], got["g"], got["b"]], -1)
    rgb_want = np.stack([want["r"], want["g"], want["b"]], -1)
    err = (np.abs(rgb_got - rgb_want)
           / np.maximum(np.abs(rgb_want), 1.0)).max(axis=-1)
    return {"mesh": mesh_shape, "seconds": secs,
            "max_rel": float(err.max()),
            "frac_rel_gt_1e-5": float((err > 1e-5).mean()),
            "path_length_equal": float(
                (got["path_length"] == want["path_length"]).mean())}


def run_cards4() -> None:
    import jax

    devs = jax.devices()
    if len(devs) < 4:
        raise SmokeError(f"--cards 4 needs four devices, found {len(devs)}")
    for shape in ("4x1", "2x2"):
        r = mesh_replay(canonical_argv(), shape, 4, OUT)
        print(f"  mesh {shape}: tpu_trace --ipus 4 in {r['seconds']:.2f} s; "
              f"vs one-card replay: max rel {r['max_rel']:.3e}, "
              f"{r['frac_rel_gt_1e-5'] * 100:.4f}% of records > 1e-5, "
              f"path lengths equal on {r['path_length_equal'] * 100:.4f}%")
        # Exact replay: only float rounding (psum order, fusion) may
        # differ, and a rounding flip may redirect a few chaotic paths.
        if r["frac_rel_gt_1e-5"] > 1e-3 or r["path_length_equal"] < 0.999:
            raise SmokeError(f"mesh {shape} disagrees with one-card replay")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, choices=(1, 4), default=1)
    args = ap.parse_args(argv)
    try:
        import jax

        print("== phase 1: device")
        dev = check_device(jax.devices())
        print(f"  JAX {jax.__version__}: {len(jax.devices())} x "
              f"{dev.device_kind} ({dev.platform})")
        print(f"  optional packages: {optional_imports()}")
        os.makedirs(OUT, exist_ok=True)
        sys.path.insert(0, REPO)
        from ipu_path_trace_tpu.runtime.exe_cache import enable_compilation_cache

        enable_compilation_cache()
        if args.cards == 4:
            print("== four-card mesh vs one-card replay")
            run_cards4()
        else:
            phases = [("canonical render", phase_canonical_render),
                      ("NIF chain vs float32 NumPy", phase_nif_chain),
                      ("wavefront vs oracle", phase_oracle),
                      ("int8, sobol and baked", phase_other_paths),
                      ("card-only tests", phase_gpu_tests)]
            for i, (name, fn) in enumerate(phases, start=2):
                print(f"== phase {i}: {name}", flush=True)
                t0 = time.monotonic()
                fn()
                print(f"   ({time.monotonic() - t0:.1f} s)", flush=True)
        info = card_info()
    except Exception:  # noqa: BLE001 - report any phase failure, exit non-zero
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    print(info)
    print(last_line(dev.platform, dev.device_kind, len(jax.devices())))
    return 0


if __name__ == "__main__":
    sys.exit(main())
