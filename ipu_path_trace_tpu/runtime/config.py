"""Application configuration - the reference's two-tier flag set.

Standard (harness) options mirror src/main.cpp:8-37; tool (render)
options mirror src/PathTracerApp.cpp:794-830, flag for flag with the
same defaults.  Additions are listed at the bottom and are purely
additive.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Config:
    # --- standard options (main.cpp:8-37) ---
    model: bool = False  # simulator: force CPU backend (IPUModel analog)
    ipus: int = 1  # number of chips to shard over (mesh size)
    save_exe: str = ""  # AOT-export compiled programs with this prefix
    load_exe: str = ""  # load previously exported programs
    compile_only: bool = False
    defer_attach: bool = False  # accepted for parity; attach is implicit in JAX
    log_level: str = "info"

    # --- tool options (PathTracerApp.cpp:794-830) ---
    outfile: str = "out.png"
    save_interval: int = 1
    width: int = 256
    height: int = 256
    samples: int = 512
    samples_per_step: int = 512
    interactive_samples: int = 8
    refractive_index: float = 1.5
    roulette_depth: int = 3
    stop_prob: float = 0.3
    aa_noise_scale: float = 0.3
    fov: float = 90.0  # degrees
    exposure: float = 0.0
    gamma: float = 2.2
    env_map_rotation: float = 0.0  # degrees
    seed: int = 1
    aa_noise_type: str = "normal"
    codelet_path: str = "./"  # accepted for parity; there are no codelets
    enable_load_balancing: bool = False
    max_path_length: int = 10
    assets: str = ""  # NIF assets dir, or "constant:r,g,b" / "texture:<file>"
    partials_type: str = "half"  # half -> bf16 matmuls, float -> f32
    available_memory_proportion: float = 0.6
    # NIF batch-serialisation cap (PathTracerApp.cpp:146-198,825-827).
    # Bounds the largest single NIF inference batch on the paths that
    # evaluate the net over a full image grid: --nif-mode=baked
    # (models/envlight.bake_nif_env) and models/reconstruct.  The
    # in-loop render path evaluates one batch per sample and does not
    # serialise.
    max_nif_batch_size: int = 30 * 1472
    ui_port: int = 0

    # --- additions ---
    # Worklist layout.  "coherent" sorts records by the primary-hit
    # class of their central ray so neighbouring lanes follow the same
    # kind of path (the SIMD inverse of the reference's MIMD long/short
    # pairing, LoadBalancer.cpp:141-192; runtime/worklist.coherent_order).
    # "raster" keeps row-major image order.  --enable-load-balancing
    # overrides either with the reference's seed-142 shuffle + per-step
    # re-deal.
    layout: str = "coherent"  # coherent | raster
    mesh_shape: str = ""  # e.g. "4x2" -> pixel x sample mesh axes; "" = 1D pixels
    # Persistent XLA compilation cache directory; JAX_COMPILATION_CACHE_DIR
    # wins when set, "" = <repo>/.jax_cache (runtime/exe_cache.py):
    cache_dir: str = ""
    rng_impl: str = "threefry2x32"  # threefry2x32 | rbg | unsafe_rbg
    # fused: MLP evaluated in-loop (reference semantics); baked: decode the
    # NIF once to an equirect texture and serve lookups (device memory is
    # plentiful, unlike IPU SRAM where compressing the HDRI was the point).
    nif_mode: str = "fused"  # fused | baked
    # NIF chain arithmetic: "auto" follows --partials-type (bf16/f32);
    # "int8" runs the quantised chain (models/quant.py).  QAT'd assets
    # ship a quant_amax.json sidecar with the activation grids their
    # fine-tune trained against.
    nif_precision: str = "auto"  # auto | int8
    profile_dir: str = ""  # XLA profiler trace dir (PVTI analog); "" = off
    device_timing: bool = False  # log the whole-step device time
    # Thin-lens depth of field; aperture 0 = the reference's pinhole:
    aperture: float = 0.0
    focal_distance: float = 1.0
    # Keep the worklist device-resident between steps and download it
    # only at save-interval boundaries.  The reference round-trips the
    # whole 20 B/pixel trace buffer every step because the host owns
    # accumulation (PathTracerApp.cpp:425-475); here the film can stay
    # on device.  Incompatible with dynamic load
    # balancing (which must inspect per-step path lengths on the host).
    # With a remote UI attached, per-step previews are tone-mapped on
    # device and only H*W*3 LDR bytes cross to the host (_device_preview);
    # the full worklist still moves only at save-interval.
    device_film: bool = False
    # JSON scene description (core/scenefile.py); "" = the reference's
    # hard-coded default scene (codelets.cpp:111-144).
    scene: str = ""
    # Mid-render checkpoint/resume (runtime/checkpoint.py): --checkpoint
    # writes the progressive state (.npz) at every save-interval and at
    # exit; --resume continues from one bitwise-identically.  The
    # reference can only restart from scratch (PathTracerApp.cpp:652-686).
    checkpoint: str = ""
    resume: str = ""
    # Restart-with-identical-args ergonomics (k8s/preemption pattern):
    # resume from --checkpoint when the file exists, start fresh when it
    # does not.  One command line serves both the first launch and every
    # restart after a kill.
    auto_resume: bool = False
    # Structured observability: append one JSON line per completed step
    # ({step, seconds, samples_per_sec, ...}) plus a final summary line.
    # The reference only logs free text (PathTracerApp.cpp:763-776).
    metrics_file: str = ""
    # Debug-visualisation save mode (film/debugview.py): replace the
    # SAVED image with a deterministic diagnostic channel (normal,
    # albedo, depth, path-length heat, escape-uv) rendered through the
    # production camera/intersector.  The accumulator is untouched.
    # Analog of the reference's DEBUG contribution case
    # (codelets.cpp:283-285) and its UV debug overwrite (:345).
    debug_view: str = ""  # "" | normal | albedo | depth | path-length | escape-uv
    # Sample-stream generator (render/qmc.py): "prng" = independent
    # counter-based uniforms (the reference's poprand-pool analog);
    # "sobol" = hash-based Owen-scrambled Sobol on the first
    # --sobol-dims path dimensions (prng beyond) - same unbiased
    # estimator, faster RMSE convergence.  Per-lane sequence indices
    # ride the worklist sampleCount, so sobol composes with
    # progressive steps, checkpoints and meshes.
    sampler: str = "prng"  # prng | sobol
    sobol_dims: int = 12  # camera (4) + whole bounces (4 each)
    # À-trous wavelet denoiser (film/denoise.py): filter SAVED images
    # with primary-hit guide buffers (albedo demodulation, normal +
    # disparity edge stopping).  A pure post-process on the save path -
    # the accumulator is untouched, so progressive refinement stays
    # unbiased and later saves start from the true Monte-Carlo state.
    # The reference saves the raw film only (AccumulatedImage.cpp:48-56).
    denoise: bool = False
    denoise_iters: int = 4  # à-trous dilation passes (filter radius 2^n)
    # Log-luminance edge-stop sigma: lower preserves more detail, higher
    # smooths harder (~0.5 suits near-converged frames, ~2 very noisy
    # previews):
    denoise_sigma: float = 1.0
    # Firefly suppressor inside --denoise: luminance clamped to k x the
    # 3x3 neighbourhood median (demodulated domain) before the wavelet
    # pass; 0 disables.  Point reflections of extreme HDR emitters are
    # single-pixel outliers the edge-stop otherwise keeps as 'detail'.
    denoise_clamp: float = 10.0

    def validate(self) -> None:
        if self.save_exe and self.load_exe:
            raise ValueError("You can not set both save-exe and load-exe.")
        if self.device_film and self.enable_load_balancing:
            raise ValueError(
                "--device-film is incompatible with --enable-load-balancing "
                "(load balancing needs per-step path lengths on the host)"
            )
        if not self.assets:
            raise ValueError("the option '--assets' is required but missing")
        if self.samples_per_step < 1 or self.samples < 1:
            raise ValueError("samples and samples-per-step must be >= 1")
        if self.samples_per_step > 0xFFFF and not self.device_film:
            # The step-wise host pipeline rides the 20-byte wire record,
            # whose u16 sampleCount clips at 65535 and would silently
            # brighten the image; the device-film path keeps int32 counts.
            raise ValueError(
                "samples-per-step > 65535 needs --device-film (the u16 "
                "wire sampleCount would clip)")
        if self.interactive_samples > 0xFFFF and not self.device_film:
            # Interactive steps ride the same wire record (the UI wire
            # path enforces this too, app._process_user_input).
            raise ValueError(
                "interactive-samples > 65535 needs --device-film (the "
                "u16 wire sampleCount would clip)")
        if self.save_interval < 1:
            raise ValueError("save-interval must be >= 1")
        if self.layout not in ("coherent", "raster"):
            raise ValueError(f"unknown --layout '{self.layout}' "
                             "(choices: coherent, raster)")
        if self.sampler not in ("prng", "sobol"):
            raise ValueError(f"unknown --sampler '{self.sampler}' "
                             "(choices: prng, sobol)")
        if self.sampler == "sobol" and self.sobol_dims < 4:
            raise ValueError("--sobol-dims must be >= 4 (the camera dims)")
        if self.denoise_iters < 1 or self.denoise_iters > 8:
            raise ValueError("--denoise-iters must be in [1, 8] "
                             "(filter radius grows as 2^n)")
        if self.denoise_sigma <= 0.0:
            raise ValueError("--denoise-sigma must be > 0")
        if self.denoise_clamp < 0.0:
            raise ValueError("--denoise-clamp must be >= 0 (0 disables)")
        if self.auto_resume and not self.checkpoint:
            raise ValueError("--auto-resume needs --checkpoint (the file "
                             "it resumes from and keeps writing)")
        if self.auto_resume and self.resume:
            raise ValueError("use either --resume or --auto-resume, not both")

    def rounded_samples_per_pixel(self) -> int:
        """Round spp up to a multiple of samples-per-step
        (roundSamplesPerPixel, PathTracerApp.cpp:19-27)."""
        spp = self.samples
        if spp % self.samples_per_step:
            spp += self.samples_per_step - (spp % self.samples_per_step)
        return spp
