"""PathTracerApp: init / build / execute orchestration.

Port of the reference application driver
(reference: src/PathTracerApp.{hpp,cpp}).  The phase split is preserved:

  init()    - graph-independent setup: load NIF assets / env light
              (PathTracerApp.cpp:60-72), also run on executable load
  build()   - construct + compile the render programs, optionally
              save/load AOT executables (build(), :310-484)
  execute() - the progressive render loop with async host pipeline,
              double-buffered worklists, optional load balancing and
              remote UI (execute(), :566-792)

Device "programs" are jitted functions in a ProgramManager; the
setup / path_trace / read_results stream trio of the reference maps to
host->device transfer, the jitted step, and device->host readback.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import jax
import jax.numpy as jnp

from ..core.records import from_device_batch, to_device_batch
from ..core.scene import default_scene
from ..film.film import Film, tone_map
from ..film.imageio import save_images
from ..models.envlight import ConstantEnv, NifEnv, TextureEnv
from ..models.nif import analyse_nif, load_nif_assets
from ..parallel.mesh import make_mesh, make_step_fn, replicate, shard_work
from ..render.params import RenderSettings, StaticConfig
from ..render.wavefront import make_base_key
from ..utils.logging import logger
from ..utils.tracing import TraceChannel
from .async_task import AsyncTask
from .config import Config
from .exe_cache import ProgramManager, enable_compilation_cache
from .worklist import LoadBalancer, coherent_order, create_tracing_jobs

# Steps without UI interaction before reverting to the performant
# samples-per-step (PathTracerApp.cpp:643,670-675):
SAMPLE_COUNT_REVERSION_STEP = 5

from functools import partial as _partial


@_partial(jax.jit, static_argnames=("width", "height"))
def _device_preview(work, perm, exposure, gamma, *, width, height):
    """Tone-mapped LDR preview computed ON DEVICE from the resident
    worklist (device-film mode): rgb/sampleCount is the running
    per-pixel mean, gathered into raster order by ``perm`` and
    tone-mapped with the reference curve ``(x * 2^exposure)^(1/gamma)``
    (AccumulatedImage.cpp:23-46).  Only H*W*3 bytes cross to the host
    per preview instead of the 20 B/pixel worklist both ways."""
    cnt = jnp.maximum(work.sample_count, 1).astype(jnp.float32)
    inv = jnp.where(work.sample_count > 0, 1.0 / cnt, 0.0)
    r = (work.r * inv)[perm]
    g = (work.g * inv)[perm]
    b = (work.b * inv)[perm]
    rgb = jnp.stack([r, g, b], axis=-1)
    scaled = jnp.maximum(rgb * jnp.exp2(exposure), 0.0)
    ldr = jnp.power(scaled, 1.0 / gamma)
    out = jnp.clip(jnp.rint(ldr * 255.0), 0.0, 255.0).astype(jnp.uint8)
    return out.reshape(height, width, 3)


@_partial(
    jax.jit,
    static_argnames=("width", "height", "iterations"),
)
def _device_preview_denoised(work, perm, exposure, gamma,
                             albedo, normal, disparity,
                             sigma_colour, clamp, *,
                             width, height, iterations):
    """Denoised LDR preview computed ON DEVICE (device-film + UI +
    --denoise): the same gather/mean as _device_preview, then the
    à-trous filter (film/denoise.py) on the resident film - the filter
    is pure XLA, so at interactive step sizes the denoise runs on the
    device and the preview stream shows the FILTERED image live.
    Guides are uploaded once per (fov, rotation, assets) key."""
    from ..film.denoise import _atrous, _firefly_clamp

    cnt = jnp.maximum(work.sample_count, 1).astype(jnp.float32)
    inv = jnp.where(work.sample_count > 0, 1.0 / cnt, 0.0)
    r = (work.r * inv)[perm]
    g = (work.g * inv)[perm]
    b = (work.b * inv)[perm]
    hdr = jnp.stack([r, g, b], axis=-1).reshape(height, width, 3)
    demod = hdr / albedo
    demod = jnp.where(clamp > 0.0, _firefly_clamp(demod, clamp), demod)
    filtered = _atrous(demod, normal, disparity, iterations,
                       sigma_colour, jnp.float32(64.0), jnp.float32(0.08))
    rgb = filtered * albedo
    scaled = jnp.maximum(rgb * jnp.exp2(exposure), 0.0)
    ldr = jnp.power(scaled, 1.0 / gamma)
    return jnp.clip(jnp.rint(ldr * 255.0), 0.0, 255.0).astype(jnp.uint8)


def parse_env_assets(assets: str, partials_type: str = "half",
                     nif_precision: str = "auto"):
    """Build the environment light from the --assets argument.

    - 'constant:R,G,B'   uniform radiance
    - 'texture:<file>'   equirect HDR texture (EXR or anything imageio reads)
    - '<dir>'            NIF assets dir: nif_metadata.txt + converted.npz
                         (or converted.hdf5)
                         (loadNifModels, PathTracerApp.cpp:106-123)

    ``nif_precision='int8'`` (--nif-precision) quantises the loaded NIF
    into the int8 chain (models/quant.py).  A QAT'd
    asset's quant_amax.json sidecar (scripts/quant_qat.py) supplies the
    activation grids its fine-tune trained against; without one the
    grids are lattice-calibrated at load (~1 s).
    """
    if assets.startswith("constant:"):
        rgb = [float(x) for x in assets.split(":", 1)[1].split(",")]
        if len(rgb) != 3:
            raise ValueError("constant env expects 'constant:R,G,B'")
        return ConstantEnv(colour=jnp.asarray(rgb, jnp.float32)), None
    if assets.startswith("texture:"):
        from ..film.imageio import load_hdr_image

        img = load_hdr_image(assets.split(":", 1)[1])
        return TextureEnv(texture=jnp.asarray(img, jnp.float32)), None
    dtype = jnp.bfloat16 if partials_type == "half" else jnp.float32
    params, meta, weights = load_nif_assets(assets, dtype)
    if nif_precision == "int8":
        from ..models.quant import quantize_nif

        amax = None
        sidecar = os.path.join(assets, "quant_amax.json")
        if os.path.exists(sidecar):
            with open(sidecar) as f:
                amax = [float(a) for a in json.load(f)["amax"]]
            logger().info("int8 NIF: using QAT activation grids from %s",
                          sidecar)
        else:
            logger().info("int8 NIF: no quant_amax.json sidecar - lattice-"
                          "calibrating (PTQ; prefer a QAT'd asset, "
                          "scripts/quant_qat.py)")
        qparams = quantize_nif(weights, meta, amax=amax)
        return NifEnv(params=qparams), (meta, weights)
    return NifEnv(params=params), (meta, weights)


class PathTracerApp:
    def __init__(self, config: Config):
        self.cfg = config
        if config.model:
            # Simulator: the IPUModel analog is the XLA CPU backend
            # (ipu_utils.hpp:78-86).  Must happen before ANY jax array is
            # created (default_scene below) or the first-used backend wins
            # and the switch is silently ignored.
            jax.config.update("jax_platforms", "cpu")
            logger().info("Using CPU simulator backend (--model).")
        self.trace = TraceChannel("path_tracer")
        self.programs = ProgramManager()
        if config.scene:
            from ..core.scenefile import load_scene

            self.scene = load_scene(config.scene)
            logger().info(
                "Loaded scene '%s': %d spheres, %d discs",
                config.scene, self.scene.num_spheres,
                self.scene.num_objects - self.scene.num_spheres,
            )
        else:
            self.scene = default_scene()
        self.env = None
        self.nif_info = None
        self.active_assets = config.assets
        self.mesh = None
        self.film: Film | None = None
        self.balancer: LoadBalancer | None = None
        self.samples_per_step = config.samples_per_step
        self.interactive = False
        # --denoise guide-buffer cache, keyed on (fov, env rotation,
        # assets) - the UI can change all three mid-run; scene geometry
        # is fixed per process.  _preview_guides holds device copies for
        # the on-device denoised preview (device-film + UI):
        self._denoise_cache: tuple[tuple, dict] | None = None
        # --debug-view path-length source: (u, v, pathLength, sampleCount)
        # arrays from the most recent worklist fetch (either pipeline):
        self._debug_soa: tuple | None = None
        self._preview_guides: tuple | None = None
        # Set by a SIGTERM/SIGINT handler (runtime/cli.py): the render
        # loop finishes the in-flight step, then takes the normal exit
        # path - final fetch, exit image save, checkpoint.  Preemption
        # of a long render must not lose completed samples.
        self.stop_requested = False

    # ------------------------------------------------------------------
    def init(self) -> None:
        cfg = self.cfg
        enable_compilation_cache(cfg.cache_dir)
        spp = cfg.rounded_samples_per_pixel()
        if spp != cfg.samples:
            logger().info(
                "Rounding SPP to next multiple of %d  (Rounded SPP := %d)",
                cfg.samples_per_step,
                spp,
            )
        self.total_spp = spp
        if not self.load_env(cfg.assets):
            # Fail fast at startup (the UI hot-swap path tolerates a
            # failed reload and keeps the current env; a run that never
            # had one would only die later, mid-execute, with a
            # misleading error after paying the full compile).
            raise ValueError(
                f"could not load environment from --assets '{cfg.assets}'")

    def load_env(self, assets: str) -> bool:
        """(Re)load the environment light; returns False on failure
        (loadNifModels semantics, PathTracerApp.cpp:106-123)."""
        try:
            self.env, self.nif_info = parse_env_assets(
                assets, self.cfg.partials_type, self.cfg.nif_precision)
        except Exception as e:
            logger().error("Could not load NIF model from '%s'. Exception: %s", assets, e)
            return False
        # The checkpoint fingerprint must record what actually lights the
        # render, which a UI hot-swap can change away from cfg.assets:
        self.active_assets = assets
        if self.nif_info is not None:
            meta, weights = self.nif_info
            info = analyse_nif(weights, self.cfg.width * self.cfg.height)
            logger().info("NIF layers: %d", info["layers"])
            logger().info("NIF hidden size: %d", info["hidden_size"])
            logger().info("NIF model FLOPS: %d", info["flops"])
            logger().info("NIF parameter size: %.1f KiB", info["parameters_kib"])
            if self.cfg.nif_mode == "baked":
                from ..models.envlight import bake_nif_env

                h, w = (meta.image_shape[:2] if len(meta.image_shape) >= 2
                        else (2048, 4096))
                t0 = time.monotonic()
                self.env = bake_nif_env(
                    self.env, int(h), int(w),
                    max_batch_size=self.cfg.max_nif_batch_size,
                )
                jax.block_until_ready(self.env.texture)
                logger().info(
                    "Baked NIF env to %dx%d texture in %.2fs (--nif-mode=baked)",
                    int(h), int(w), time.monotonic() - t0,
                )
        return True

    # ------------------------------------------------------------------
    def static_config(self) -> StaticConfig:
        return StaticConfig(
            width=self.cfg.width,
            height=self.cfg.height,
            max_path_length=self.cfg.max_path_length,
            aa_noise_type=self.cfg.aa_noise_type,
            sampler=self.cfg.sampler,
            sobol_dims=self.cfg.sobol_dims,
        )

    def local_samples(self, samples_per_step: int) -> int:
        """Per-chip sample count when a sample mesh axis is in use."""
        if self.mesh is not None:
            sm = self.mesh.shape["samples"]
            if samples_per_step % sm:
                raise ValueError(
                    f"samples-per-step {samples_per_step} must divide by the "
                    f"sample mesh axis ({sm})"
                )
            return samples_per_step // sm
        return samples_per_step

    def _guides(self, state: dict) -> dict:
        """--denoise guide buffers for the CURRENT camera/env state,
        cached on (fov, env rotation, assets) - the UI can move all
        three mid-run (sky albedo = env radiance along the centre ray,
        so rotation and hot-swaps change it)."""
        import math

        from ..film.denoise import primary_features

        cfg = self.cfg
        key = (float(state["fov"]), float(state["env_rotation"]),
               self.active_assets)
        if self._denoise_cache is None or self._denoise_cache[0] != key:
            host_scene = jax.tree.map(np.asarray, self.scene)
            host_env = jax.tree.map(np.asarray, self.env)
            with self.trace.span("denoise_guides"):
                guides = primary_features(
                    host_scene, cfg.width, cfg.height,
                    math.radians(key[0]), env=host_env,
                    azimuth=math.radians(key[1]),
                    max_batch=cfg.max_nif_batch_size)
            self._denoise_cache = (key, guides)
            self._preview_guides = None  # device copies follow the key
        return self._denoise_cache[1]

    def _save_films(self, film: Film, n: int, state: dict) -> None:
        """Write the -o outputs for the film normalised at step ``n``.

        With --denoise the saved HDR and LDR are the à-trous-filtered
        image (film/denoise.py); the accumulator itself is never touched,
        so later saves refine from the raw Monte-Carlo state.
        """
        cfg = self.cfg
        if cfg.debug_view:
            # Diagnostic channel instead of radiance (the reference's
            # DEBUG contribution case, codelets.cpp:283-285): rendered
            # through the production camera/intersector via the denoiser
            # guide pass; the accumulator is untouched.
            from ..film.debugview import debug_ldr, debug_view, mean_path_length

            plm = None
            if cfg.debug_view == "path-length":
                if self._debug_soa is None:
                    logger().warning(
                        "--debug-view path-length: no worklist fetched "
                        "yet; writing a zero heat map")
                    plm = np.zeros((cfg.height, cfg.width), np.float32)
                else:
                    plm = mean_path_length(*self._debug_soa,
                                           cfg.width, cfg.height)
            with self.trace.span("debug_view"):
                img = debug_view(cfg.debug_view, self._guides(state), plm,
                                 cfg.max_path_length)
            save_images(cfg.outfile, img, debug_ldr(img, state["gamma"]))
            return
        hdr = film.hdr_at_step(n)
        if cfg.denoise:
            from ..film.denoise import denoise_hdr

            guides = self._guides(state)
            with self.trace.span("denoise"):
                hdr = denoise_hdr(hdr, guides,
                                  iterations=cfg.denoise_iters,
                                  sigma_colour=cfg.denoise_sigma,
                                  firefly_clamp=cfg.denoise_clamp)
            ldr = tone_map(hdr, 1, state["exposure"], state["gamma"])
        else:
            ldr = film.ldr(n, state["exposure"], state["gamma"])
        save_images(cfg.outfile, hdr, ldr)

    def settings(self, samples_per_step: int, fov_deg=None, env_rot_deg=None) -> RenderSettings:
        cfg = self.cfg
        return RenderSettings.make(
            fov_degrees=cfg.fov if fov_deg is None else fov_deg,
            aa_scale=cfg.aa_noise_scale,
            env_rotation_degrees=cfg.env_map_rotation if env_rot_deg is None else env_rot_deg,
            refractive_index=cfg.refractive_index,
            stop_prob=cfg.stop_prob,
            roulette_depth=cfg.roulette_depth,
            samples_per_step=self.local_samples(samples_per_step),
            aperture=cfg.aperture,
            focal_distance=cfg.focal_distance,
            seed=cfg.seed,  # -> sobol_key (render-wide Owen-scramble key)
        )

    def build(self) -> None:
        """Register and (optionally) AOT-compile the device programs."""
        cfg = self.cfg
        if cfg.ipus > 1 or cfg.mesh_shape:
            # An explicit --mesh-shape forces the mesh path even at
            # --ipus 1 (a 1x1 mesh), so the shard_map code also compiles
            # and runs on a single device.
            self.mesh = make_mesh(cfg.ipus, cfg.mesh_shape)
            logger().info("Device mesh: %s", dict(self.mesh.shape))
            self.scene = replicate(self.scene, self.mesh)
            self.env = replicate(self.env, self.mesh)
        with self.trace.span("create_path_tracing_jobs"):
            n_px = self.mesh.shape["pixels"] if self.mesh is not None else 1
            worklist = create_tracing_jobs(cfg.width, cfg.height, multiple_of=n_px)
            self.balancer = LoadBalancer(len(worklist))
            if cfg.enable_load_balancing:
                # The reference's seed-142 shuffle spreads work across IPU
                # tiles (LoadBalancer.cpp:118-139) and pairs with the
                # per-step path-length re-deal, so shuffle only when
                # dynamic balancing asked for it.
                if cfg.layout == "coherent":
                    logger().info(
                        "--enable-load-balancing overrides --layout with the "
                        "reference's shuffle + per-step re-deal")
                self.balancer.randomise_work_list(worklist)
            else:
                if cfg.layout == "coherent":
                    # Primary-hit-sorted records keep neighbouring lanes
                    # on the same kind of path (the SIMD inverse of the
                    # reference's long/short pairing;
                    # runtime/worklist.coherent_order).
                    worklist = coherent_order(
                        worklist, self.scene, cfg.width, cfg.height,
                        cfg.fov, shards=n_px)
                self.balancer.work.inactive = worklist.copy()
            self.balancer.work.active = self.balancer.work.inactive.copy()
        self.film = Film(cfg.width, cfg.height)

        # Debug-level tensor/sharding dump (logTensorInfo analog,
        # reference: src/io_utils.hpp:50-63):
        from ..utils.introspect import log_tensor_info

        log_tensor_info("scene", self.scene)
        log_tensor_info("env", self.env)

        step_fn = make_step_fn(self.static_config(), self.mesh, rng_impl=self.cfg.rng_impl)
        self.programs.add("path_trace", step_fn)

        if cfg.load_exe:
            with self.trace.span("load_exe"):
                if not self.programs.load(cfg.load_exe):
                    raise RuntimeError(f"Could not load executable '{cfg.load_exe}'")
            return

        if cfg.save_exe or cfg.compile_only:
            with self.trace.span("compile"):
                args = self._example_args()
                # Trigger compilation (and warm the persistent cache):
                out = step_fn(*args)
                jax.block_until_ready(out)
                to_save = {"path_trace": args}
            if cfg.save_exe:
                with self.trace.span("save_exe"):
                    self.programs.save(cfg.save_exe, to_save)

    def _example_args(self):
        work = to_device_batch(self.balancer.work.active)
        if self.mesh is not None:
            work = shard_work(work, self.mesh)
        return (
            self.scene,
            self.settings(self.samples_per_step),
            work,
            # Raw key words: typed keys break AOT-exported programs at
            # call time (make_step_fn docstring):
            jax.random.key_data(make_base_key(self.cfg.seed, self.cfg.rng_impl)),
            self.env,
        )

    # ------------------------------------------------------------------
    def execute(self, ui_server=None, max_steps: int | None = None) -> Film:
        """The progressive render loop (execute(), PathTracerApp.cpp:566-792)."""
        cfg = self.cfg
        assert self.film is not None and self.balancer is not None
        film = self.film
        balancer = self.balancer

        state = {
            "exposure": cfg.exposure,
            "gamma": cfg.gamma,
            "fov": cfg.fov,
            "env_rotation": cfg.env_map_rotation,
            "interactive_samples": cfg.interactive_samples,
        }
        if ui_server is not None:
            self.samples_per_step = cfg.interactive_samples
            self.interactive = True
            if hasattr(ui_server, "seed_state"):
                # The server's protocol defaults must not clobber CLI
                # values on the first consumed state change (ui/server.py
                # seed_state docstring); fields the client already sent
                # win.  hasattr: tests drive execute() with stub servers.
                ui_server.seed_state(dict(state))

        steps = self.total_spp // cfg.samples_per_step
        if max_steps is not None:
            steps = min(steps, max_steps)
        host = AsyncTask()
        # Device-resident film: keep the worklist on device between
        # steps, download only at save-interval boundaries (Config
        # docstring).  With a UI attached, per-step previews are
        # tone-mapped ON DEVICE and only H*W*3 LDR bytes cross to the
        # host (_device_preview) - the full worklist still only moves
        # at save-interval.
        device_film = cfg.device_film
        work_dev_resident = None
        df_dirty = False  # device-resident samples newer than the film?
        raster_perm = None
        if device_film:
            from ..core.records import raster_permutation

            raster_perm = jnp.asarray(
                raster_permutation(balancer.work.active, cfg.width, cfg.height)
            )
        key = make_base_key(cfg.seed, cfg.rng_impl)
        total_rays = {"n": 0}
        # Film content newer than the on-disk outfile, recorded as the
        # normalization step to save it at (0 = disk is current).  With a
        # UI attached, save-interval images are STREAMED instead of saved
        # (reference: PathTracerApp.cpp:750-760), so a remote stop - or a
        # natural finish - would otherwise leave -o empty; the exit save
        # below persists whatever the film holds.
        disk_pending = {"norm": 0}
        # --- mid-render checkpoint/resume (runtime/checkpoint.py) ---
        # Step keys are fold_in(key, step), independent of history, so a
        # resumed render continues bitwise-identically (for headless runs;
        # interactive step sizes vary and carry no such claim).
        start_step = 1
        ckpt_written = {"step": 0}

        def current_fp():
            """Live fingerprint overrides: what actually lights the samples
            (the UI can mutate fov/rotation/assets away from cfg).  Must be
            captured on the MAIN thread at host-task dispatch - read inside
            the async task, a concurrent UI change could stamp a checkpoint
            with values that did not light the saved samples."""
            return {
                "fov": float(state["fov"]),
                "env_map_rotation": float(state["env_rotation"]),
                "assets": self.active_assets,
            }

        def write_ckpt(at_step, *, hdr=None, soa=None, fp=None):
            if not cfg.checkpoint or at_step <= ckpt_written["step"]:
                return
            from .checkpoint import save_checkpoint

            layouts = None
            if cfg.enable_load_balancing and hdr is not None:
                # The re-deal layout chain has a two-buffer lag: active
                # is the layout step at_step+1 will upload, inactive the
                # one for at_step+2 (re-dealt just above in this host
                # task).  u,v order is all the re-deal state there is -
                # accumulators were cleared, and the step itself never
                # reorders records (checkpoint.py module docstring).
                layouts = {
                    "active_u": balancer.work.active["u"].copy(),
                    "active_v": balancer.work.active["v"].copy(),
                    "inactive_u": balancer.work.inactive["u"].copy(),
                    "inactive_v": balancer.work.inactive["v"].copy(),
                }
            with self.trace.span("checkpoint"):
                save_checkpoint(
                    cfg.checkpoint, cfg, at_step, hdr=hdr, soa=soa,
                    layouts=layouts,
                    # fp is bound at dispatch by async callers; main-thread
                    # callers (exit paths) read the live values directly:
                    fingerprint_overrides=fp if fp is not None else current_fp(),
                )
            ckpt_written["step"] = at_step

        def emit_metrics(record: dict) -> None:
            """Append one JSON line to --metrics-file (fleet-readable
            observability; the reference logs free text only)."""
            if not cfg.metrics_file:
                return
            with open(cfg.metrics_file, "a") as f:
                f.write(json.dumps(record) + "\n")

        resume_path = cfg.resume
        if not resume_path and cfg.auto_resume:
            # Restart-with-identical-args: resume from the checkpoint
            # this run also writes, when a previous attempt left one.
            import os

            if os.path.exists(cfg.checkpoint):
                resume_path = cfg.checkpoint
            else:
                logger().info(
                    "--auto-resume: no checkpoint at '%s'; starting fresh",
                    cfg.checkpoint)
        if resume_path:
            from .checkpoint import load_checkpoint

            done_step, mode, saved = load_checkpoint(resume_path, cfg)
            if mode != ("soa" if device_film else "hdr"):
                raise ValueError(
                    f"checkpoint mode '{mode}' does not match this run")
            layouts = saved.pop("layouts")
            if device_film:
                from ..core.records import WorkBatch

                work_dev_resident = WorkBatch(
                    **{k: jnp.asarray(v) for k, v in saved.items()})
                if self.mesh is not None:
                    work_dev_resident = shard_work(work_dev_resident, self.mesh)
                df_dirty = True
            else:
                film.hdr[...] = saved["hdr"]
                disk_pending["norm"] = done_step  # not yet on disk here
                if cfg.enable_load_balancing:
                    # Restore the re-deal chain: both double-buffer
                    # layouts, accumulators zeroed (write_ckpt saved
                    # them post-clear; checkpoint.py module docstring).
                    if set(layouts) != {"active_u", "active_v",
                                        "inactive_u", "inactive_v"}:
                        raise ValueError(
                            "checkpoint has no load-balancer layouts; it "
                            "was written without --enable-load-balancing")
                    for name in ("active", "inactive"):
                        buf = getattr(balancer.work, name)
                        if len(layouts[f"{name}_u"]) != len(buf):
                            raise ValueError(
                                "checkpoint worklist size "
                                f"{len(layouts[f'{name}_u'])} != {len(buf)}")
                        buf[...] = 0
                        buf["u"] = layouts[f"{name}_u"]
                        buf["v"] = layouts[f"{name}_v"]
            start_step = done_step + 1
            logger().info(
                "Resumed from '%s': %d steps already rendered", resume_path,
                done_step)
        settings_sig = None
        settings = None
        if cfg.profile_dir:
            # XLA profiler trace of the whole render loop - the analog of the
            # reference's PVTI instrumentation (PathTracerApp.cpp:636-776);
            # view with tensorboard / xprof.
            jax.profiler.start_trace(cfg.profile_dir)
            logger().info("Profiler trace -> '%s'", cfg.profile_dir)
        if cfg.device_timing:
            # Whole-step device time at the real render shape - the
            # analog of the reference's per-step cycle counters
            # (PathTracerApp.cpp:438-462); see utils/devtime.py.  On a
            # mesh the sharded step is timed and reported per chip.
            from ..utils.devtime import log_step_timing, measure_step

            with self.trace.span("device_timing"):
                timing = measure_step(
                    self.scene, self.settings(self.samples_per_step),
                    self.static_config(), to_device_batch(balancer.work.active),
                    key, self.env, mesh=self.mesh,
                )
            log_step_timing(timing)
        start_time = time.monotonic()
        logger().info("Render started")

        step = start_step
        while step <= steps:
            if self.stop_requested:
                logger().info(
                    "Stop requested (signal); exiting after step %d",
                    step - 1)
                break
            loop_start = time.monotonic()

            # --- UI processing (PathTracerApp.cpp:652-686) ---
            if ui_server is not None and ui_server.state_changed():
                with self.trace.span("ui_processing"):
                    ui_state = ui_server.consume_state()
                    status = self._process_user_input(ui_state, state, ui_server)
                    if status == "stop":
                        break
                    if status == "disconnected":
                        ui_server = None
                    elif status == "restart":
                        host.wait_for_completion()
                        film.reset()
                        disk_pending["norm"] = 0  # film is empty again
                        balancer.clear_active_accumulators()
                        work_dev_resident = None  # device-film: re-upload cleared
                        ckpt_written["step"] = 0  # restart: re-checkpoint from 1
                        start_time = time.monotonic()
                        step = 1
                        self.samples_per_step = state["interactive_samples"]
            elif (step >= SAMPLE_COUNT_REVERSION_STEP and self.interactive
                  and self.samples_per_step != cfg.samples_per_step):
                # >= not ==: a UI event landing exactly on the reversion
                # step consumes that iteration's branch, and the render
                # must still revert on the next one (else it would finish
                # at interactive_samples forever).
                self.samples_per_step = cfg.samples_per_step
                self.interactive = ui_server is not None
                logger().debug(
                    "Interaction stopped reverting samples per step to: %d",
                    self.samples_per_step,
                )

            # Rebuild the settings pytree only when an input changed
            # (each rebuild uploads ~9 scalars):
            sig = (self.samples_per_step, state["fov"], state["env_rotation"])
            if sig != settings_sig:
                settings = self.settings(
                    self.samples_per_step, fov_deg=state["fov"],
                    env_rot_deg=state["env_rotation"],
                )
                if self.mesh is not None:
                    # Reused arrays are committed after first use; give
                    # them the same replicated sharding as scene/env so
                    # they stay compatible with the mesh step:
                    settings = replicate(settings, self.mesh)
                settings_sig = sig

            # --- device render: setup -> path_trace -> read_results ---
            with self.trace.span("ipu_render"):
                step_key = jax.random.key_data(jax.random.fold_in(key, step))
                if device_film:
                    # Upload once; thereafter the worklist (and with it
                    # the film accumulation) stays on device.
                    if work_dev_resident is None:
                        work_dev_resident = to_device_batch(balancer.work.active)
                        if self.mesh is not None:
                            work_dev_resident = shard_work(work_dev_resident, self.mesh)
                    work_dev_resident = self.programs.run(
                        "path_trace", self.scene, settings, work_dev_resident,
                        step_key, self.env,
                    )
                    fetched = None
                    if step % cfg.save_interval == 0 or step == steps:
                        # Fetch the SoA batch as-is: the u16 wire record
                        # clips sampleCount at 65535 while the resident
                        # film's counts grow for the whole render, so the
                        # film must accumulate from the int32 counts
                        # (Film.accumulate_soa).
                        fetched = jax.tree.map(np.asarray, work_dev_resident)
                    elif step % 16 == 0:
                        # Drain the dispatch queue: every enqueued step
                        # pre-allocates its 20 B/pixel output in device
                        # memory, so hundreds of in-flight steps (a long
                        # render with a sparse save-interval) pile up
                        # gigabytes.  A scalar fetch bounds the queue at
                        # 16 steps (~350 MB at 1104x1000).
                        with self.trace.span("queue_drain"):
                            float(work_dev_resident.r[0])
                    df_dirty = fetched is None
                else:
                    work_dev = to_device_batch(balancer.work.active)
                    if self.mesh is not None:
                        work_dev = shard_work(work_dev, self.mesh)
                    out = self.programs.run(
                        "path_trace", self.scene, settings, work_dev, step_key, self.env
                    )
                    records = from_device_batch(out)  # blocks on device completion
                    balancer.work.active = records

            if device_film:
                # Minimal host pipeline: the records carry EVERY step's
                # sums, so a fetch rebuilds the film in one pass - each
                # record's rgb / sampleCount is the running per-pixel
                # mean, i.e. exactly hdr_at_step(step) of the step-wise
                # path (sum_k (rgb_k/sps) / k == sum rgb / (k*sps)).
                with self.trace.span("wait_for_host"):
                    host.wait_for_completion()
                if ui_server is not None:
                    # Device-side tone map + raster gather; only the
                    # LDR preview crosses to the host each step:
                    live = ui_server.get_state()
                    state["exposure"] = live["exposure"]
                    state["gamma"] = live["gamma"]
                    with self.trace.span("ui_preview"):
                        if cfg.denoise:
                            g = self._guides(state)
                            if self._preview_guides is None:
                                # Floor the albedo exactly like the host
                                # save path (denoise_hdr) so black-diffuse
                                # or non-positive-env pixels never divide
                                # 0/0 into the wavelet filter.
                                self._preview_guides = (
                                    jnp.maximum(jnp.asarray(g["albedo"]),
                                                1e-3),
                                    jnp.asarray(g["normal"]),
                                    jnp.asarray(g["disparity"]))
                            ldr = np.asarray(
                                _device_preview_denoised(
                                    work_dev_resident, raster_perm,
                                    jnp.float32(state["exposure"]),
                                    jnp.float32(state["gamma"]),
                                    *self._preview_guides,
                                    jnp.float32(cfg.denoise_sigma),
                                    jnp.float32(cfg.denoise_clamp),
                                    width=cfg.width, height=cfg.height,
                                    iterations=cfg.denoise_iters,
                                )
                            )
                        else:
                            ldr = np.asarray(
                                _device_preview(
                                    work_dev_resident, raster_perm,
                                    jnp.float32(state["exposure"]),
                                    jnp.float32(state["gamma"]),
                                    width=cfg.width, height=cfg.height,
                                )
                            )
                    with self.trace.span("ui_encode"):
                        ui_server.send_preview_image(ldr)
                    ui_server.update_progress(step, steps)
                if fetched is not None:
                    def device_film_processing(step=step, wb=fetched,
                                               ui=ui_server, fp=current_fp()):
                        with self.trace.span("accumulate_framebuffers"):
                            film.reset()
                            film.accumulate_soa(
                                wb.u, wb.v, wb.r, wb.g, wb.b, wb.sample_count
                            )
                        self._debug_soa = (wb.u, wb.v, wb.path_length,
                                           wb.sample_count)
                        write_ckpt(step, soa=wb._asdict(), fp=fp)
                        disk_pending["norm"] = 1
                        if ui is not None:
                            ui.start_sending_raw_image(film.hdr_at_step(1))
                        else:
                            with self.trace.span("save_images"):
                                disk_pending["norm"] = 0
                                self._save_films(film, 1, state)
                                logger().info("Saved images at step %d", step)

                    host.run(device_film_processing)
                secs = time.monotonic() - loop_start
                sample_rate = cfg.width * cfg.height * self.samples_per_step / secs
                logger().info(
                    "Completed render step %d/%d in %.3f seconds (Samples/sec %.3g)",
                    step, steps, secs, sample_rate,
                )
                if ui_server is not None:
                    ui_server.update_sample_rate(sample_rate, 0.0)
                emit_metrics({"step": step, "steps": steps,
                              "seconds": round(secs, 4),
                              "samples_per_sec": round(sample_rate, 1),
                              "spp_per_step": int(self.samples_per_step)})
                if step == start_step:
                    self._log_device_memory()
                step += 1
                continue

            # --- host pipeline (PathTracerApp.cpp:700-761) ---
            with self.trace.span("wait_for_host"):
                host.wait_for_completion()
            balancer.work.swap()

            step_for_task = step
            sps_for_task = self.samples_per_step

            def host_processing(step=step_for_task, sps=sps_for_task,
                                ui=ui_server, fp=current_fp()):
                with self.trace.span("accumulate_framebuffers"):
                    film.accumulate(balancer.work.inactive)
                if cfg.debug_view == "path-length":
                    # Copies: clear_inactive_accumulators zeroes the
                    # per-step pathLength in place below, before the
                    # save-path reads it.
                    rec = balancer.work.inactive
                    self._debug_soa = (rec["u"].copy(), rec["v"].copy(),
                                       rec["pathLength"].copy(),
                                       rec["sampleCount"].copy())
                disk_pending["norm"] = step
                if ui is not None:
                    # Tone-mapping reads the LIVE UI state - exposure/gamma
                    # deliberately don't restart the render (the reference
                    # reads uiServer->getState() in the async lambda,
                    # PathTracerApp.cpp:726-737):
                    live = ui.get_state()
                    state["exposure"] = live["exposure"]
                    state["gamma"] = live["gamma"]
                    with self.trace.span("tone_map"):
                        if cfg.denoise:
                            from ..film.denoise import denoise_hdr

                            dn = denoise_hdr(
                                film.hdr_at_step(step), self._guides(state),
                                iterations=cfg.denoise_iters,
                                sigma_colour=cfg.denoise_sigma,
                                firefly_clamp=cfg.denoise_clamp)
                            ldr = tone_map(dn, 1, state["exposure"],
                                           state["gamma"])
                        else:
                            ldr = film.ldr(step, state["exposure"],
                                           state["gamma"])
                    with self.trace.span("ui_encode"):
                        ui.send_preview_image(ldr)
                    ui.update_progress(step, steps)
                if cfg.enable_load_balancing and step > 1:
                    with self.trace.span("run_load_balancing"):
                        balancer.allocate_work_by_path_length()
                with self.trace.span("clear_accumulators"):
                    total_rays["n"] = balancer.clear_inactive_accumulators()
                if step % cfg.save_interval == 0 or step == steps:
                    write_ckpt(step, hdr=film.hdr, fp=fp)
                    if ui is not None:
                        ui.start_sending_raw_image(film.hdr_at_step(step))
                    else:
                        with self.trace.span("save_images"):
                            disk_pending["norm"] = 0
                            self._save_films(film, step, state)
                            logger().info("Saved images at step %d", step)

            host.run(host_processing)

            # --- stats (PathTracerApp.cpp:763-776) ---
            secs = time.monotonic() - loop_start
            sample_rate = cfg.width * cfg.height * self.samples_per_step / secs
            ray_rate = total_rays["n"] / secs  # lags one step like the async source it reads
            logger().info(
                "Completed render step %d/%d in %.3f seconds (Samples/sec %.3g) (Rays/sec %.3g)",
                step,
                steps,
                secs,
                sample_rate,
                ray_rate,
            )
            if ui_server is not None:
                ui_server.update_sample_rate(sample_rate, ray_rate)
            emit_metrics({"step": step, "steps": steps,
                          "seconds": round(secs, 4),
                          "samples_per_sec": round(sample_rate, 1),
                          "rays_per_sec": round(ray_rate, 1),
                          "spp_per_step": int(self.samples_per_step)})
            if step == start_step:
                self._log_device_memory()
            step += 1

        host.wait_for_completion()
        if device_film and df_dirty and work_dev_resident is not None:
            # Early exit (UI stop) between save-interval fetches: pull the
            # device-resident accumulation so no completed samples are
            # lost - the step-wise path's film is current every step.
            with self.trace.span("final_fetch"):
                wb = jax.tree.map(np.asarray, work_dev_resident)
                film.reset()
                film.accumulate_soa(wb.u, wb.v, wb.r, wb.g, wb.b, wb.sample_count)
            write_ckpt(step - 1, soa=wb._asdict())
            disk_pending["norm"] = 1
            if ui_server is not None:
                ui_server.start_sending_raw_image(film.hdr_at_step(1))
        if not device_film:
            # Early stop between save-intervals: the film already holds
            # every completed step (accumulated per step), so checkpoint
            # it before the exit save.
            write_ckpt(step - 1, hdr=film.hdr)
        # Persist anything the outfile does not have yet - an interrupted
        # render (remote stop / disconnect) and any UI-attached run whose
        # save-interval images were streamed rather than written must
        # still honour -o with the completed samples:
        if disk_pending["norm"] > 0:
            n = disk_pending["norm"]
            with self.trace.span("save_images"):
                self._save_films(film, n, state)
                logger().info("Saved images at exit (step %d)", n)
        if cfg.profile_dir:
            jax.profiler.stop_trace()
        elapsed = time.monotonic() - start_time
        logger().info("Render finished: %.3f seconds", elapsed)
        pixels = cfg.width * cfg.height
        samples_per_sec = (pixels / elapsed) * self.total_spp
        logger().info("Samples/sec: %.4g", samples_per_sec)
        logger().info("Samples/sec/chip: %.4g", samples_per_sec / max(1, cfg.ipus))
        emit_metrics({"event": "summary",
                      "elapsed_seconds": round(elapsed, 3),
                      "total_spp": int(self.total_spp),
                      "samples_per_sec": round(samples_per_sec, 1),
                      "chips": max(1, cfg.ipus)})
        return film

    # ------------------------------------------------------------------
    def _log_device_memory(self) -> None:
        """One-shot device-memory report after the first completed step.

        Catches on-device footprint regressions (e.g. a dispatch-queue
        pileup) without a profiler run.  memory_stats is an accelerator
        feature; backends without it skip.
        """
        try:
            stats = jax.devices()[0].memory_stats() or {}
        except Exception:  # noqa: BLE001 - introspection must never fail a render
            return
        used = stats.get("bytes_in_use")
        if used is None:
            return
        peak = stats.get("peak_bytes_in_use")
        limit = stats.get("bytes_limit")
        logger().info(
            "Device memory after first step: %.0f MiB in use%s%s",
            used / 2**20,
            f", peak {peak / 2**20:.0f} MiB" if peak else "",
            f", limit {limit / 2**20:.0f} MiB" if limit else "",
        )

    # ------------------------------------------------------------------
    def _process_user_input(self, ui_state, state, ui_server) -> str:
        """processUserInput (PathTracerApp.cpp:531-564)."""
        if ui_state.get("stop"):
            logger().info("Rendering stopped by remote UI")
            return "stop"
        if ui_state.get("detach"):
            logger().info("Remote UI disconnected.")
            return "disconnected"
        nif_failed = False
        new_nif = ui_state.get("load_nif")
        if new_nif:
            logger().info("Loading NIF: %s", new_nif)
            if self.load_env(new_nif):
                if self.mesh is not None:
                    # build() replicated the original env over the mesh; a
                    # reloaded one must be too or shard_map rejects it:
                    self.env = replicate(self.env, self.mesh)
            else:
                nif_failed = True  # env unchanged; don't discard the film
        # Track whether anything that changes rendered VALUES actually
        # changed: a state message whose only payload is invalid (or a
        # resend of current values) must not destroy the accumulated
        # film with a restart that changes nothing.
        render_changed = bool(new_nif) and not nif_failed
        for k in ("exposure", "gamma"):  # tonemap-only: never restarts
            if k in ui_state:
                state[k] = ui_state[k]
        for k in ("env_rotation", "fov"):
            if k in ui_state:
                if k not in state or float(ui_state[k]) != float(state[k]):
                    render_changed = True
                state[k] = ui_state[k]
        if "interactive_samples" in ui_state:
            # Wire values are untrusted: <1 would render zero-sample
            # steps, on a sample mesh axis a non-divisible count would
            # raise out of settings() and kill the whole render, and
            # >65535 would clip the u16 wire sampleCount in the
            # step-wise host pipeline (silently brightening the image).
            v = int(ui_state["interactive_samples"])
            try:
                if v < 1:
                    raise ValueError("must be >= 1")
                if v > 0xFFFF and not self.cfg.device_film:
                    raise ValueError(
                        "> 65535 needs --device-film (u16 wire clip)")
                self.local_samples(v)
                if v != state.get("interactive_samples"):
                    render_changed = True
                state["interactive_samples"] = v
            except ValueError as e:
                logger().warning(
                    "Ignoring invalid interactive_samples=%r from UI: %s",
                    v, e)
        return "restart" if render_changed else "none"
