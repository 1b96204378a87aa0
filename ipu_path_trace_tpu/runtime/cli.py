"""The `tpu_trace` command line - flag parity with the `ipu_trace` binary.

Two option tiers exactly as the reference (standard harness options,
src/main.cpp:8-37; tool options, src/PathTracerApp.cpp:794-830),
including short aliases (-o, -w, -H for height since argparse
reserves -h for help, -s, -n, -a) and validation
(save/load mutual exclusion, main.cpp:62-66).
"""

from __future__ import annotations

import argparse
import sys

from ..utils.logging import logger, set_log_level
from .config import Config


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tpu_trace",
        description="Neural path tracer (ipu_path_trace re-designed for JAX/XLA accelerators).",
        add_help=False,
    )
    std = p.add_argument_group("Options")
    std.add_argument("--help", action="help", help="Show command help.")
    std.add_argument("--model", action="store_true",
                     help="Use the CPU simulator backend instead of the accelerator.")
    std.add_argument("--ipus", type=int, default=1, metavar="N",
                     help="Number of chips to shard the render over.")
    std.add_argument("--save-exe", default="", metavar="NAME",
                     help="Save compiled executables using this name (prefix).")
    std.add_argument("--load-exe", default="", metavar="NAME",
                     help="Load previously saved executables with this prefix and skip compilation.")
    std.add_argument("--compile-only", action="store_true",
                     help="If set with save-exe, exit after compiling and saving.")
    std.add_argument("--defer-attach", action="store_true",
                     help="Accepted for parity; device attach is implicit in JAX.")
    std.add_argument("--log-level", default="info",
                     choices=["trace", "debug", "info", "warn", "err", "critical", "off"])

    tool = p.add_argument_group("Tool options")
    tool.add_argument("--outfile", "-o", required=True, help="Set output file name.")
    tool.add_argument("--save-interval", type=int, default=1)
    tool.add_argument("--width", "-w", type=int, default=256, help="Output image width (total pixels).")
    tool.add_argument("--height", "-H", type=int, default=256, help="Output image height (total pixels).")
    tool.add_argument("--samples", "-s", type=int, default=512, help="Total samples to take per pixel.")
    tool.add_argument("--samples-per-step", type=int, default=512, help="Samples to take per device step.")
    tool.add_argument("--interactive-samples", type=int, default=8,
                      help="Samples per device step during user interaction.")
    tool.add_argument("--refractive-index", "-n", type=float, default=1.5, help="Refractive index.")
    tool.add_argument("--roulette-depth", type=int, default=3,
                      help="Number of bounces before rays are randomly stopped.")
    tool.add_argument("--stop-prob", type=float, default=0.3, help="Probability of a ray being stopped.")
    tool.add_argument("--aa-noise-scale", "-a", type=float, default=0.3,
                      help="Scale of anti-aliasing noise (pixels).")
    tool.add_argument("--fov", type=float, default=90.0, help="Horizontal field of view (degrees).")
    tool.add_argument("--exposure", type=float, default=0.0, help="Exposure compensation for tone-mapping.")
    tool.add_argument("--gamma", type=float, default=2.2, help="Gamma correction for tone-mapping.")
    tool.add_argument("--env-map-rotation", type=float, default=0.0,
                      help="Azimuthal rotation for HDRI environment map (degrees).")
    tool.add_argument("--seed", type=int, default=1, help="Seed for random number generation.")
    tool.add_argument("--aa-noise-type", default="normal",
                      choices=["uniform", "normal", "truncated-normal"])
    tool.add_argument("--codelet-path", default="./",
                      help="Accepted for parity; there are no codelets.")
    tool.add_argument("--enable-load-balancing", action="store_true",
                      help="Run the dynamic load balancing algorithm for path tracing.")
    tool.add_argument("--max-path-length", type=int, default=10)
    tool.add_argument("--assets", required=True,
                      help="Path to the 'assets.extra' directory of the saved NIF model, "
                      "or 'constant:R,G,B' / 'texture:<image>' for non-neural env lights.")
    tool.add_argument("--partials-type", default="half", choices=["half", "float"],
                      help="Matmul compute precision: half -> bfloat16, float -> float32.")
    tool.add_argument("--available-memory-proportion", type=float, default=0.6,
                      help="Accepted for parity (reference: memory proportion for matmuls).")
    tool.add_argument("--max-nif-batch-size", type=int, default=30 * 1472,
                      help="Batch size for NIF serialisation when evaluating the net "
                           "over a full image grid (--nif-mode baked, models/reconstruct).")
    tool.add_argument("--ui-port", type=int, default=0,
                      help="Start a remote user-interface server on the specified port.")

    extra = p.add_argument_group("Additional options")
    extra.add_argument("--mesh-shape", default="",
                     help="Device mesh as 'PIXELSxSAMPLES', e.g. '4x2'. Default: all chips on the pixel axis.")
    extra.add_argument("--layout", default="coherent",
                     choices=["coherent", "raster"],
                     help="Worklist layout: 'coherent' sorts records by "
                          "primary-hit class so neighbouring lanes follow the "
                          "same kind of path (default); "
                          "'raster' keeps row-major image order. "
                          "--enable-load-balancing overrides either with the "
                          "reference's shuffle + per-step re-deal.")
    extra.add_argument("--cache-dir", default="",
                     help="Persistent compilation cache directory (default "
                          "<repo>/.jax_cache; ignored when "
                          "JAX_COMPILATION_CACHE_DIR is set).")
    extra.add_argument("--profile-dir", default="",
                     help="Write an XLA profiler trace of the render loop here "
                          "(the PVTI-instrumentation analog; view with xprof).")
    extra.add_argument("--device-timing", action="store_true", default=False,
                     help="Measure and log the per-sample device time of the "
                          "whole step at the render shape before the loop "
                          "starts - the cycle-counter analog of the reference.")
    extra.add_argument("--aperture", type=float, default=0.0,
                     help="Thin-lens aperture radius (scene units); 0 = pinhole.")
    extra.add_argument("--focal-distance", type=float, default=1.0,
                     help="Focus-plane distance for depth of field.")
    extra.add_argument("--nif-mode", default="fused", choices=["fused", "baked"],
                     help="fused: NIF MLP evaluated inside the render loop "
                          "(reference semantics); baked: decode the NIF once "
                          "to an equirect texture and use bilinear lookups "
                          "(azimuth needs no re-bake).")
    extra.add_argument("--nif-precision", default="auto",
                     choices=["auto", "int8"],
                     help="NIF chain arithmetic: auto follows "
                          "--partials-type; int8 quantises the chain "
                          "(models/quant.py; prefer QAT'd assets with a "
                          "quant_amax.json).")
    extra.add_argument("--scene", default="",
                     help="JSON scene description (spheres/discs with colour, "
                          "emission, material); default: the reference's "
                          "built-in scene. See core/scenefile.py for the schema.")
    extra.add_argument("--device-film", action="store_true", default=False,
                     help="Keep the worklist device-resident between steps and "
                          "download results only at save-interval boundaries "
                          "(the reference round-trips the trace "
                          "buffer every step).  With --ui-port, previews are "
                          "tone-mapped on device (LDR bytes only).  "
                          "Incompatible with --enable-load-balancing.")
    extra.add_argument("--metrics-file", default="",
                     help="Append one JSON line per completed render step "
                          "(step, seconds, samples_per_sec, spp) plus a "
                          "final summary - machine-readable observability "
                          "for fleet/production monitoring.")
    extra.add_argument("--checkpoint", default="",
                     help="Write the progressive render state to this .npz at "
                          "every save-interval and at exit, so an interrupted "
                          "render can be continued with --resume (with "
                          "--enable-load-balancing the re-deal layouts are "
                          "saved too, keeping resume bitwise-exact).")
    extra.add_argument("--resume", default="",
                     help="Continue a render from a --checkpoint file; the "
                          "combined result is bitwise-identical to an "
                          "uninterrupted run (the render config must match "
                          "the checkpoint's fingerprint).")
    extra.add_argument("--auto-resume", action="store_true", default=False,
                     help="With --checkpoint: resume from the checkpoint "
                          "file when it exists, start fresh when it does "
                          "not - one identical command line serves the "
                          "first launch and every post-preemption restart.")
    extra.add_argument("--rng-impl", default="threefry2x32",
                     choices=["threefry2x32", "rbg", "unsafe_rbg"],
                     help="Counter-based PRNG (threefry2x32 is reproducible "
                          "across backends and replayed by the NumPy oracle).")
    extra.add_argument("--sampler", default="prng", choices=["prng", "sobol"],
                     help="Sample-stream generator: prng = independent "
                          "uniforms (reference behaviour); sobol = hash-based "
                          "Owen-scrambled Sobol on the leading path "
                          "dimensions - the same unbiased estimator with "
                          "faster RMSE convergence per sample.")
    extra.add_argument("--sobol-dims", type=int, default=12,
                     help="With --sampler sobol: how many leading path "
                          "dimensions ride the Sobol sequence (camera 4 + 4 "
                          "per bounce; rounded down to whole bounces, prng "
                          "beyond).")
    extra.add_argument("--denoise", action="store_true", default=False,
                     help="Filter SAVED images with the edge-avoiding a-trous "
                          "wavelet denoiser (primary-hit albedo/normal/depth "
                          "guides, film/denoise.py).  Post-process only: the "
                          "accumulator stays raw, so progressive refinement "
                          "remains unbiased.")
    extra.add_argument("--denoise-iters", type=int, default=4,
                     help="A-trous dilation passes for --denoise (filter "
                          "radius 2^n pixels).")
    extra.add_argument("--denoise-sigma", type=float, default=1.0,
                     help="Log-luminance edge-stop sigma for --denoise: "
                          "lower keeps more detail, higher smooths harder "
                          "(~0.5 near-converged, ~2 very noisy previews).")
    extra.add_argument("--denoise-clamp", type=float, default=10.0,
                     help="Firefly suppressor for --denoise: clamp each "
                          "pixel's luminance to k x its 3x3 neighbourhood "
                          "median before filtering (0 disables).")
    extra.add_argument("--debug-view", default="",
                     choices=["", "normal", "albedo", "depth", "path-length",
                              "escape-uv"],
                     help="Save a diagnostic channel instead of radiance "
                          "(film/debugview.py), rendered through the "
                          "production camera/intersector.  The accumulator "
                          "is untouched.  The reference's DEBUG contribution "
                          "analog (codelets.cpp:283-285, :345).")
    return p


def parse_config(argv=None) -> Config:
    args = build_parser().parse_args(argv)
    cfg = Config(
        model=args.model,
        ipus=args.ipus,
        save_exe=args.save_exe,
        load_exe=args.load_exe,
        compile_only=args.compile_only,
        defer_attach=args.defer_attach,
        log_level=args.log_level,
        outfile=args.outfile,
        save_interval=args.save_interval,
        width=args.width,
        height=args.height,
        samples=args.samples,
        samples_per_step=args.samples_per_step,
        interactive_samples=args.interactive_samples,
        refractive_index=args.refractive_index,
        roulette_depth=args.roulette_depth,
        stop_prob=args.stop_prob,
        aa_noise_scale=args.aa_noise_scale,
        fov=args.fov,
        exposure=args.exposure,
        gamma=args.gamma,
        env_map_rotation=args.env_map_rotation,
        seed=args.seed,
        aa_noise_type=args.aa_noise_type,
        codelet_path=args.codelet_path,
        enable_load_balancing=args.enable_load_balancing,
        max_path_length=args.max_path_length,
        assets=args.assets,
        partials_type=args.partials_type,
        available_memory_proportion=args.available_memory_proportion,
        max_nif_batch_size=args.max_nif_batch_size,
        ui_port=args.ui_port,
        layout=args.layout,
        mesh_shape=args.mesh_shape,
        cache_dir=args.cache_dir,
        rng_impl=args.rng_impl,
        nif_mode=args.nif_mode,
        nif_precision=args.nif_precision,
        profile_dir=args.profile_dir,
        device_timing=args.device_timing,
        aperture=args.aperture,
        focal_distance=args.focal_distance,
        device_film=args.device_film,
        scene=args.scene,
        checkpoint=args.checkpoint,
        resume=args.resume,
        auto_resume=args.auto_resume,
        metrics_file=args.metrics_file,
        sampler=args.sampler,
        sobol_dims=args.sobol_dims,
        denoise=args.denoise,
        denoise_iters=args.denoise_iters,
        denoise_sigma=args.denoise_sigma,
        denoise_clamp=args.denoise_clamp,
        debug_view=args.debug_view,
    )
    cfg.validate()
    return cfg


def main(argv=None) -> int:
    try:
        cfg = parse_config(argv)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    set_log_level(cfg.log_level)
    try:
        from .app import PathTracerApp

        app = PathTracerApp(cfg)
        app.init()
        app.build()
        if cfg.compile_only:
            logger().info("Compile-only run finished.")
            return 0
        ui_server = None
        if cfg.ui_port:
            # Blocks until a client connects (PathTracerApp.cpp:620-634):
            from ..ui.server import InterfaceServer

            ui_server = InterfaceServer(cfg.ui_port)
            ui_server.start()
            logger().info("Waiting for remote UI client to connect...")
            if not ui_server.wait_for_client():
                # A failed bind (port in use) must not silently degrade
                # into a headless interactive-rate render:
                ui_server.stop()
                raise RuntimeError(
                    f"UI server failed to accept a client on port "
                    f"{cfg.ui_port} (port in use?)")
            ui_server.initialise_video_stream(cfg.width, cfg.height)
        # Graceful preemption: first SIGTERM/SIGINT finishes the
        # in-flight step and takes the normal exit path (final fetch,
        # exit image save, --checkpoint write); a second signal restores
        # default handling (hard kill).  A preempted job must not
        # lose completed samples.
        import signal

        prev = {}

        def _graceful(signum, frame):
            logger().info("Received signal %d; finishing current step "
                          "and saving (send again to force-quit)", signum)
            app.stop_requested = True
            for s, h in prev.items():
                signal.signal(s, h)

        for s in (signal.SIGTERM, signal.SIGINT):
            try:
                prev[s] = signal.signal(s, _graceful)
            except (ValueError, OSError):
                pass  # non-main thread / unsupported platform
        try:
            app.execute(ui_server=ui_server)
        finally:
            for s, h in prev.items():
                try:
                    signal.signal(s, h)
                except (ValueError, OSError):
                    pass
            if ui_server is not None:
                ui_server.stop()
        return 0
    except Exception as e:
        logger().error("%s", e)
        if cfg.log_level in ("trace", "debug"):
            raise
        return 1


if __name__ == "__main__":
    sys.exit(main())
