"""Test configuration: run everything on a virtual 8-device CPU mesh.

Mirrors the reference's IPUModel simulator strategy (reference:
src/ipu_utils.hpp:78-86): the same compiled code runs on a simulated
target so multi-chip sharding is testable without hardware.

Unless JAX_PLATFORMS names another platform, the tests run on the CPU
(XLA_FLAGS must be set before the CPU client is instantiated).  The
card-only tier (``-m gpu``) runs with JAX_PLATFORMS=cuda, or in-process
from chip_smoke.py; its tests take the ``gpu_device`` fixture, which
skips where there is no card.
"""

import os

ON_CPU = os.environ.get("JAX_PLATFORMS", "cpu") == "cpu"
if ON_CPU:
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = flags + " --xla_force_host_platform_device_count=8"
    os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402
import pytest  # noqa: E402

if ON_CPU:
    jax.config.update("jax_platforms", "cpu")
    assert jax.default_backend() == "cpu", jax.default_backend()
    assert len(jax.devices()) == 8, jax.devices()


@pytest.fixture
def gpu_device():
    """The first GPU device.  Skips where there is none - decided here,
    at run time, so every xdist worker collects the same tests."""
    gpus = [d for d in jax.devices() if d.platform == "gpu"]
    if not gpus:
        pytest.skip("needs a GPU: run on the card (python chip_smoke.py)")
    return gpus[0]


# ---------------------------------------------------------------------------
# Quick tier (pytest -m quick): a curated <=5 min subset that still touches
# every subsystem (core math, kernels, mesh, runtime, models, film, ui, ...).
# The full suite is unchanged; this only ADDS a marker.  Kept central so the
# wall-time budget is auditable in one place — tests were chosen from a
# --durations=0 run of the full suite on the 1-core CI box.
# ---------------------------------------------------------------------------

# Whole files that are cheap end to end:
QUICK_FILES = {
    "test_core_math.py",
    "test_film_io.py",
    "test_scenefile.py",
    "test_quick_tier.py",
}

# Files deliberately absent from the quick tier (each needs a reason —
# test_quick_tier.py::test_every_file_has_quick_representation fails on
# any test file that is neither quick-represented nor waived here):
WAIVED_QUICK = {
    # Bit-exactness across process restarts: every test re-renders the
    # same frame twice; the cheapest case is ~40 s on the CI box.
    "test_determinism.py",
    # Loads the shipped 6x320 urban-alley NIF asset and re-scores its
    # PSNR against the generator output: ~90 s of pure reconstruct.
    "test_shipped_assets.py",
    # Card-only tier: every test skips on the CPU.
    "test_gpu.py",
}

# Individual fast representatives (file, test base name — all params):
QUICK_TESTS = {
    # runtime: records, worklist/load-balancer (+C++ twin), async, CLI
    ("test_runtime.py", "test_trace_record_layout"),
    ("test_runtime.py", "test_max_rays_per_tile"),
    ("test_runtime.py", "test_create_tracing_jobs_padding"),
    ("test_runtime.py", "test_load_balancer_redeal"),
    ("test_runtime.py", "test_load_balancer_native_numpy_parity"),
    ("test_runtime.py", "test_load_balancer_clear_and_sum"),
    ("test_runtime.py", "test_worklist_swap"),
    ("test_runtime.py", "test_async_task"),
    ("test_runtime.py", "test_coherent_order_is_a_sorted_permutation"),
    ("test_runtime.py", "test_cli_layout_flag"),
    ("test_runtime.py", "test_cli_parity_flags"),
    ("test_runtime.py", "test_cli_save_load_exclusive"),
    ("test_runtime.py", "test_cli_requires_assets_and_outfile"),
    ("test_runtime.py", "test_spp_rounding"),
    ("test_runtime.py", "test_readme_commands_parse"),
    # oracle parity: one exact-replay case keeps the render math honest
    ("test_oracle_parity.py", "test_constant_env_parity"),
    # render step accounting + NIF chain against plain NumPy
    ("test_render_step.py", "test_zero_samples_is_identity"),
    ("test_render_step.py", "test_counts_and_path_length_sums"),
    ("test_nif_reference.py", "test_nif_apply_matches_numpy_f32"),
    ("test_nif_reference.py", "test_npz_weights_equal_hdf5"),
    # the chip smoke test's CPU-side helpers
    ("test_chip_smoke.py", "test_refuses_non_gpu_backend"),
    ("test_chip_smoke.py", "test_last_line_format"),
    ("test_bench.py", "test_unknown_device_kind_is_error"),
    ("test_bench.py", "test_trace_split_finds_named_scopes"),
    # models: codec, trainer round-trip, batch-serialised reconstruct
    ("test_nif_train.py", "test_encode_decode_inverse"),
    ("test_nif_train.py", "test_uv_grid_matches_reference"),
    ("test_nif_train.py", "test_reconstruct_batch_serialisation"),
    # int8 quantization: PTQ scales, tile-padding exactness, kernel parity
    ("test_quant.py", "test_quantize_shapes_and_scales"),
    ("test_quant.py", "test_packed_chain_bitwise_vs_twin"),
    ("test_quant.py", "test_quant_tracks_f32"),
    # saved-model converter
    ("test_convert.py", "test_snappy_decompress_with_copies"),
    ("test_convert.py", "test_read_tensor_bundle_roundtrip"),
    ("test_convert.py", "test_convert_cli"),
    # mesh/sharding
    ("test_mesh.py", "test_parse_mesh_shape"),
    ("test_mesh.py", "test_pixel_sharding"),
    ("test_mesh.py", "test_sample_axis_psum"),
    ("test_mesh.py", "test_worklist_divisibility_error"),
    ("test_mesh.py", "test_four_device_replay"),
    # QMC sampler
    ("test_qmc.py", "test_net_property_every_dim"),
    ("test_qmc.py", "test_2d_stratification_aa_dims"),
    ("test_qmc.py", "test_pixel_and_key_decorrelation"),
    ("test_qmc.py", "test_sobol_dims_used_clamps"),
    # checkpoint/resume
    ("test_checkpoint.py", "test_checkpoint_validation"),
    ("test_checkpoint.py", "test_resume_rejects_mismatched_config"),
    ("test_checkpoint.py", "test_corrupt_checkpoint_rejected"),
    # AOT exe cache
    ("test_exe_cache.py", "test_save_load_roundtrip"),
    ("test_exe_cache.py", "test_load_rejects_missing_and_empty_manifest"),
    ("test_exe_cache.py", "test_duplicate_program_name_rejected"),
    ("test_exe_cache.py", "test_compilation_cache_dir_rule"),
    # device film
    ("test_device_film.py", "test_accumulate_soa_over_u16_counts"),
    ("test_device_film.py", "test_raster_permutation_rejects_bad_worklists"),
    ("test_device_film.py", "test_device_film_rejects_load_balancing"),
    ("test_device_film.py", "test_device_preview_matches_host_tonemap"),
    # env bake (--max-nif-batch-size)
    ("test_envbake.py", "test_bake_exact_at_lattice"),
    ("test_envbake.py", "test_bake_honours_max_batch_size"),
    ("test_envbake.py", "test_app_wires_max_nif_batch_size"),
    # observability
    ("test_observability.py", "test_metrics_file_jsonl"),
    # UI server / packetcomms / video
    ("test_ui.py", "test_state_updates"),
    ("test_ui.py", "test_preview_frame"),
    ("test_ui.py", "test_fmp4_mjpeg_roundtrip"),
    ("test_ui.py", "test_port_in_use_fails_fast"),
    # RMSE artifact coverage check (pure)
    ("test_rmse_artifact.py", "test_rmse_config_list_covers_baseline"),
    # debug-view save modes (film/debugview.py) minus the app e2e
    ("test_debugview.py", "test_mean_path_length_scatter"),
    ("test_debugview.py", "test_debug_view_modes"),
    # denoiser (film/denoise.py) minus the app e2e
    ("test_denoise.py", "test_primary_features_match_scene"),
    ("test_denoise.py", "test_flat_region_variance_reduction"),
    ("test_denoise.py", "test_edge_preserved_across_guide_boundary"),
    ("test_denoise.py", "test_albedo_demodulation_exact"),
    ("test_denoise.py", "test_denoise_iters_validated"),
}


def pytest_collection_modifyitems(config, items):
    matched: set = set()
    collected_files: set = set()
    for item in items:
        fname = item.nodeid.split("::")[0].rsplit("/", 1)[-1]
        base = item.name.split("[")[0]
        collected_files.add(fname)
        if fname in QUICK_FILES or (fname, base) in QUICK_TESTS:
            item.add_marker(pytest.mark.quick)
            matched.add((fname, base))
    # Drift guard: a renamed or deleted test must not silently drop out
    # of the quick tier.  Only judge entries whose FILE was collected —
    # running a single other file must not trip the guard — and skip it
    # entirely when specific node IDs were requested (pytest file.py::t
    # collects just that test, which would false-positive every other
    # entry of the same file).
    if any("::" in str(a) for a in config.invocation_params.args):
        return
    stale = sorted(
        f"{f}::{n}" for (f, n) in QUICK_TESTS
        if f in collected_files and (f, n) not in matched
    )
    if stale:
        raise pytest.UsageError(
            "QUICK_TESTS entries matched no collected test (renamed or "
            "deleted? update tests/conftest.py): " + ", ".join(stale))
