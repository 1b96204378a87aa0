"""The wavefront path-trace step: one jittable program per render step.

This replaces the reference's per-tile megakernel pipeline
(gen-rays -> path-trace -> pre-process -> NIF -> apply-env -> accumulate,
reference: src/PathTracerApp.cpp:432-458) with a single SPMD program over
the whole pixel batch:

  * ray-gen: AA jitter + pixel_to_ray over the SoA worklist
    (codelets.cpp:36-80)
  * bounce loop: lax.scan over max_path_length with per-lane alive masks
    replacing the divergent per-ray while loop (codelets.cpp:173-216)
  * throughput accumulation runs forwards - provably equal to the
    reference's backward contribution-stack walk (codelets.cpp:261-292):
    products commute, and radiance is only deposited at EMIT/ESCAPED
    terminals
  * escaped rays record direction + throughput; the environment light
    (constant / texture / NIF MLP) is applied afterwards to the whole
    batch at once - the deferral the reference implements with
    Pre/PostProcessEscapedRays (codelets.cpp:312-385), which turns the
    NIF into one large batched matmul chain
  * the on-device sample loop (popops::countedForLoop,
    PathTracerApp.cpp:466-468) is a lax.scan over sample indices.

RNG is counter-based (threefry keys derived from (step key, sample,
bounce)) instead of the reference's pre-generated noise pools
(PathTracerApp.cpp:285-299).  The derivation is a pure function, so the
NumPy oracle can replay the identical stream for bit-near-exact tests.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core.camera import aa_noise, pixel_to_ray
from ..core.envmap import equirect_uv
from ..core.geometry import intersect_scene
from ..core.materials import (
    DIFFUSE_SCALE,
    REFRACT_WEIGHT,
    reflect,
    refract,
    sample_diffuse,
)
from ..core.records import WorkBatch
from ..core.scene import Material, Scene
from ..core.vecmath import Vec3
from ..models.envlight import eval_env
from .params import RenderSettings, StaticConfig

# Key-derivation tags (shared with the CPU oracle in cpu/oracle.py):
AA_TAG = 0x0AA
LENS_TAG = 0x1E5
BOUNCE_TAG = 0xB0


class QmcCtx(NamedTuple):
    """Per-lane context for the Owen-Sobol sampler (render/qmc.py).

    ``base`` is each lane's accumulated sample count (the worklist's own
    sampleCount field), so sample s of this step draws Sobol point
    base + s of the lane's scrambled sequence - continuous across
    progressive steps, restarts and checkpoints.  ``key`` is the
    render-wide scramble key (settings.sobol_key).
    """

    pixel_id: jnp.ndarray  # (P,) int32 v * width + u
    base: jnp.ndarray  # (P,) int32 accumulated per-lane sample counts
    key: jnp.ndarray  # uint32 scalar


def make_qmc_ctx(work: WorkBatch, cfg, settings) -> QmcCtx | None:
    if cfg.sampler != "sobol":
        return None
    pixel_id = work.v.astype(jnp.int32) * cfg.width + work.u.astype(jnp.int32)
    return QmcCtx(pixel_id=pixel_id, base=work.sample_count.astype(jnp.int32),
                  key=settings.sobol_key)


def sobol_dims_used(cfg) -> int:
    """Leading noise-layout rows carried by the Sobol sequence: a whole
    number of bounces after the 4 camera dims, capped by the layout."""
    if cfg.sampler != "sobol":
        return 0
    d = max(4, (cfg.sobol_dims // 4) * 4)
    return min(d, 4 + 4 * cfg.max_path_length)


def apply_thin_lens(d: Vec3, settings, l1, l2) -> tuple[Vec3, Vec3]:
    """Thin-lens camera: jitter the origin on a disk, refocus through the
    focus plane at ``focal_distance`` along -z.  Aperture 0 degenerates
    exactly to the reference's pinhole ((o, d) unchanged).

    ``d`` must be normalised; (l1, l2) are per-ray uniforms in [0, 1).
    Returns (origin, direction).
    """
    r = settings.aperture * jnp.sqrt(l1)
    phi = (2.0 * jnp.pi) * l2
    lx = r * jnp.cos(phi)
    ly = r * jnp.sin(phi)
    # Focus point of the pinhole ray on the plane z = -focal_distance:
    t_f = settings.focal_distance / jnp.maximum(-d.z, 1e-8)
    o = Vec3(lx, ly, jnp.zeros_like(lx))
    new_d = Vec3(d.x * t_f - lx, d.y * t_f - ly, d.z * t_f).normalized()
    # Keep the pinhole case BIT-exact (renormalisation would flip last
    # ulps and break exact-replay oracle tests):
    dof = settings.aperture > 0.0
    return o.where(dof, Vec3.zeros(lx.shape)), new_d.where(dof, d)


def make_base_key(seed: int, rng_impl: str = "threefry2x32") -> jax.Array:
    """Base PRNG key for a render.

    ``threefry2x32`` (the default) is reproducible across backends and
    is what the NumPy oracle replays (cpu/oracle.py).  Every impl is
    counter-based, the analog of poprand's per-tile streams
    (reference: src/PathTracerApp.cpp:266-299).
    """
    return jax.random.key(seed, impl=rng_impl)


def sample_key(base_key: jax.Array, sample_idx) -> jax.Array:
    return jax.random.fold_in(base_key, sample_idx)


def bounce_uniforms(skey: jax.Array, bounce_idx, n: int) -> jnp.ndarray:
    """(4, n) uniforms for one bounce: [rr, bsdf_u1, bsdf_u2, fresnel]."""
    kb = jax.random.fold_in(skey, BOUNCE_TAG + bounce_idx)
    return jax.random.uniform(kb, (4, n), jnp.float32)


class _BounceState(NamedTuple):
    o: Vec3
    d: Vec3
    throughput: Vec3
    radiance: Vec3
    alive: jnp.ndarray
    esc_dir: Vec3
    esc_w: Vec3  # throughput * rrFactor at escape (zero if not escaped)
    escaped: jnp.ndarray
    path_len: jnp.ndarray  # int32 pushes (reference pathLength semantics)


def initial_state(o: Vec3, d: Vec3, n: int) -> _BounceState:
    return _BounceState(
        o=o,
        d=d,
        throughput=Vec3.full((n,), 1.0, 1.0, 1.0),
        radiance=Vec3.zeros((n,)),
        alive=jnp.ones((n,), bool),
        esc_dir=Vec3.zeros((n,)),
        esc_w=Vec3.zeros((n,)),
        escaped=jnp.zeros((n,), bool),
        path_len=jnp.zeros((n,), jnp.int32),
    )


def bounce_body(
    scene: Scene, settings: RenderSettings, state: _BounceState, rnd, bounce_idx
) -> _BounceState:
    """One wavefront bounce over the whole batch with masked lanes.

    ``rnd`` is (4, n): [rr, bsdf_u1, bsdf_u2, fresnel].  Shared by the
    lax.scan driver (trace_one_sample) and the injected-uniforms driver
    (trace_sample_with_uniforms).
    """
    n = state.o.x.shape[0]
    rr_rand, u1, u2, fresnel_rand = rnd[0], rnd[1], rnd[2], rnd[3]

    # Russian roulette (codelets.cpp:175-180): kicks in at
    # depth >= roulette_depth; survivors weighted by 1/(1-p).
    rr_on = bounce_idx >= settings.roulette_depth
    rr_stop = rr_on & (rr_rand <= settings.stop_prob)
    rr_factor = jnp.where(rr_on, 1.0 / (1.0 - settings.stop_prob), 1.0)
    alive = state.alive & ~rr_stop

    hit = intersect_scene(scene, state.o, state.d)

    # Escaped rays: record direction + weighted throughput for the
    # deferred environment lookup (codelets.cpp:185-189).
    escaped_now = alive & ~hit.valid
    esc_dir = state.d.where(escaped_now, state.esc_dir)
    esc_w = (state.throughput * rr_factor).where(escaped_now, state.esc_w)
    escaped = state.escaped | escaped_now

    # Emitters terminate the path (codelets.cpp:192-196):
    emit_now = alive & hit.valid & hit.emissive
    emit_add = state.throughput.cwise(hit.emission) * rr_factor
    radiance = state.radiance + emit_add.where(emit_now, Vec3.zeros((n,)))

    alive = alive & hit.valid & ~hit.emissive

    # BSDF sampling with masked lanes (codelets.cpp:198-213):
    d_diff, cos_theta = sample_diffuse(hit.normal, u1, u2)
    d_spec = reflect(state.d, hit.normal)
    d_refr, refracted = refract(
        state.d, hit.normal, settings.refractive_index, fresnel_rand
    )

    is_diff = hit.material == int(Material.DIFFUSE)
    is_spec = hit.material == int(Material.SPECULAR)
    new_d = d_diff.where(is_diff, d_spec.where(is_spec, d_refr))

    one = Vec3.full((n,), 1.0, 1.0, 1.0)
    # Throughput multipliers (contribution weights of codelets.cpp:198-213
    # applied forwards):
    w_diff = hit.colour * (cos_theta * DIFFUSE_SCALE * rr_factor)
    w_spec = one * rr_factor
    tint = hit.colour.where(refracted, one)
    w_refr = tint * (REFRACT_WEIGHT * rr_factor)
    scale = w_diff.where(is_diff, w_spec.where(is_spec, w_refr))

    throughput = state.throughput.cwise(scale).where(alive, state.throughput)
    new_o = hit.point.where(alive, state.o)
    new_d = new_d.where(alive, state.d)

    # pathLength counts stack pushes: one per scatter/terminal event
    # (TraceRecord semantics via resizeContributionArray,
    # WrappedArray.hpp:45-68, codelets.cpp:253).
    pushed = escaped_now | emit_now | alive
    path_len = state.path_len + pushed.astype(jnp.int32)

    return _BounceState(
        o=new_o,
        d=new_d,
        throughput=throughput,
        radiance=radiance,
        alive=alive,
        esc_dir=esc_dir,
        esc_w=esc_w,
        escaped=escaped,
        path_len=path_len,
    )


def draw_aa_jitter(u1, u2, aa_noise_type: str):
    """AA jitter pair from two uniforms in (0, 1]: uniform (2u - 1),
    normal (Box-Muller) or truncated-normal clipped at +/-3 sigma - the
    distributions of core/camera.aa_noise."""
    if aa_noise_type == "uniform":
        return 2.0 * u1 - 1.0, 2.0 * u2 - 1.0
    r = jnp.sqrt(-2.0 * jnp.log(u1))
    z1 = r * jnp.cos((2.0 * jnp.pi) * u2)
    z2 = r * jnp.sin((2.0 * jnp.pi) * u2)
    if aa_noise_type == "truncated-normal":
        z1 = jnp.clip(z1, -3.0, 3.0)
        z2 = jnp.clip(z2, -3.0, 3.0)
    return z1, z2


def sample_noise(
    skey: jax.Array,
    n: int,
    cfg: StaticConfig,
    qmc_ctx: QmcCtx | None = None,
    sample_idx=None,
) -> jnp.ndarray:
    """(4 + 4L, n) noise for one sample in the injected-uniforms layout
    (trace_sample_with_uniforms): [0:2] AA jitter (already distributed),
    [2:4] lens uniforms, [4+4b:8+4b] bounce-b uniforms.

    prng mode draws with the exact fold_in schedule of
    trace_one_sample's scan branch, so both drivers replay the same
    streams.  sobol mode (qmc_ctx given; sample_idx = the sample's index
    within the step) fills the first sobol_dims_used(cfg) rows from each
    lane's Owen-Sobol sequence at index base + sample_idx (render/qmc.py)
    and pads the rest with the prng schedule.
    """
    qd = sobol_dims_used(cfg) if qmc_ctx is not None else 0
    if qd == 0:
        aa = aa_noise(jax.random.fold_in(skey, AA_TAG), (2, n), cfg.aa_noise_type)
        lens = jax.random.uniform(jax.random.fold_in(skey, LENS_TAG), (2, n))
        bounce = [bounce_uniforms(skey, b, n) for b in range(cfg.max_path_length)]
        return jnp.concatenate([aa, lens, *bounce], axis=0)

    from .qmc import sobol_uniforms

    idx = qmc_ctx.base + jnp.int32(0 if sample_idx is None else sample_idx)
    us = sobol_uniforms(idx, qmc_ctx.pixel_id, qmc_ctx.key, range(qd))
    # AA rows carry the TRANSFORMED jitter (Box-Muller / clip / 2u-1):
    a1, a2 = draw_aa_jitter(us[0], us[1], cfg.aa_noise_type)
    sobol_rows = jnp.stack([a1, a2, us[2], us[3], *us[4:qd]])  # (qd, n)
    prng_tail = [
        bounce_uniforms(skey, b, n)  # (4, n) each
        for b in range((qd - 4) // 4, cfg.max_path_length)
    ]
    return jnp.concatenate([sobol_rows, *prng_tail], axis=0)


def trace_sample_with_uniforms(
    scene: Scene,
    settings: RenderSettings,
    cfg: StaticConfig,
    cols: jnp.ndarray,
    rows: jnp.ndarray,
    aa: jnp.ndarray,  # (2, P) anti-alias jitter (already distributed)
    lens: jnp.ndarray,  # (2, P) lens-disk uniforms in [0, 1)
    uniforms: jnp.ndarray,  # (L, 4, P) per-bounce uniforms
) -> _BounceState:
    """Statically-unrolled trace with injected randomness (the sobol
    sampler's driver and the oracle tests' stream-replay entry point)."""
    c = cols + settings.aa_scale * aa[0]
    r = rows + settings.aa_scale * aa[1]
    d = pixel_to_ray(c, r, cfg.width, cfg.height, settings.fov).normalized()
    o, d = apply_thin_lens(d, settings, lens[0], lens[1])
    state = initial_state(o, d, cols.shape[0])
    for i in range(cfg.max_path_length):
        state = bounce_body(scene, settings, state, uniforms[i], i)
    return state


def trace_one_sample(
    scene: Scene,
    settings: RenderSettings,
    cfg: StaticConfig,
    cols: jnp.ndarray,  # (P,) float32 pixel columns (worklist u)
    rows: jnp.ndarray,  # (P,) float32 pixel rows (worklist v)
    skey: jax.Array,
    env,
    qmc_ctx: QmcCtx | None = None,  # sobol-mode per-lane context
    sample_idx=None,  # sobol mode: the sample's index within the step
) -> tuple[Vec3, jnp.ndarray]:
    """Trace one sample per worklist entry; returns (radiance, path_len)."""
    n = cols.shape[0]

    # Named scopes label the device time of each phase in a profiler
    # trace (bench.py's trace split reads them):
    with jax.named_scope("trace"):
        if cfg.sampler == "sobol" and qmc_ctx is not None:
            # Owen-Sobol streams are pre-assembled in the injected-uniforms
            # layout - one code path for the sampler and the oracle's
            # stream replay.
            noise = sample_noise(skey, n, cfg, qmc_ctx, sample_idx)
            state = trace_sample_with_uniforms(
                scene, settings, cfg, cols, rows,
                noise[0:2], noise[2:4],
                noise[4:].reshape(cfg.max_path_length, 4, n),
            )
        else:
            # --- ray generation (GenerateCameraRays, codelets.cpp:47-79) ---
            kaa = jax.random.fold_in(skey, AA_TAG)
            noise = aa_noise(kaa, (2, n), cfg.aa_noise_type)
            c = cols + settings.aa_scale * noise[0]
            r = rows + settings.aa_scale * noise[1]
            d = pixel_to_ray(c, r, cfg.width, cfg.height, settings.fov).normalized()
            lens = jax.random.uniform(jax.random.fold_in(skey, LENS_TAG), (2, n))
            o, d = apply_thin_lens(d, settings, lens[0], lens[1])

            state = initial_state(o, d, n)

            def bounce(state: _BounceState, bounce_idx):
                rnd = bounce_uniforms(skey, bounce_idx, n)
                return bounce_body(scene, settings, state, rnd, bounce_idx), None

            state, _ = jax.lax.scan(
                bounce, state, jnp.arange(cfg.max_path_length, dtype=jnp.int32)
            )

    with jax.named_scope("env_light"):
        # --- deferred environment lighting (codelets.cpp:312-385) ---
        u, v = equirect_uv(state.esc_dir, settings.azimuth)
        # Zero the non-escaped lanes like PreProcessEscapedRays does to avoid
        # FP garbage (codelets.cpp:348-352):
        u = jnp.where(state.escaped, u, 0.0)
        v = jnp.where(state.escaped, v, 0.0)
        env_rgb = eval_env(env, u, v)
        radiance = state.radiance + state.esc_w.cwise(env_rgb)
    return radiance, state.path_len


def render_step_impl(
    scene: Scene,
    settings: RenderSettings,
    cfg: StaticConfig,
    work: WorkBatch,
    step_key: jax.Array,
    env,
    sample_axis_index=0,
) -> WorkBatch:
    """Run cfg.samples_per_step samples and accumulate into the worklist.

    The device-side sampling loop is the analog of the reference's
    on-device countedForLoop over path-trace iterations
    (PathTracerApp.cpp:466-468).  Accumulation matches
    AccumulateContributions (codelets.cpp:294-300): rgb sums, sampleCount
    increments, pathLength sums.

    ``sample_axis_index`` (traced scalar) is this replica's position on
    a "samples" mesh axis: sobol mode offsets each lane's sequence index
    by index * samples_per_step so replicas draw DISJOINT slices of the
    per-pixel sequence (the worklist's psum'd sampleCount is the global
    count, so the slices line up across steps).  prng mode decorrelates
    via the step key instead (parallel/mesh.local_step) and ignores it.
    """
    cols = work.u.astype(jnp.float32)
    rows = work.v.astype(jnp.float32)
    qmc_ctx = make_qmc_ctx(work, cfg, settings)
    if qmc_ctx is not None:
        off = jnp.int32(sample_axis_index) * settings.samples_per_step.astype(jnp.int32)
        qmc_ctx = qmc_ctx._replace(base=qmc_ctx.base + off)

    def body(sample_idx, carry):
        rad, plen = carry
        skey = sample_key(step_key, sample_idx)
        r, p = trace_one_sample(
            scene, settings, cfg, cols, rows, skey, env, qmc_ctx, sample_idx
        )
        return (rad + r, plen + p)

    init = (Vec3.zeros(cols.shape), jnp.zeros(cols.shape, jnp.int32))
    # Dynamic trip count = the streamed deviceSampleLimit analog
    # (PathTracerApp.cpp:466-468); fori_loop keeps it a runtime value.
    rad, plen = jax.lax.fori_loop(0, settings.samples_per_step, body, init)

    return WorkBatch(
        u=work.u,
        v=work.v,
        r=work.r + rad.x,
        g=work.g + rad.y,
        b=work.b + rad.z,
        sample_count=work.sample_count + settings.samples_per_step,
        path_length=work.path_length + plen,
    )


# Single-chip entry point; multi-chip goes through parallel.mesh which
# wraps render_step_impl in a shard_map.
render_step = partial(jax.jit, static_argnames=("cfg",))(render_step_impl)
