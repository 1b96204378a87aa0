"""Render parameters, split by compilation behaviour.

StaticConfig changes recompile the step (shapes / loop bounds /
sampler); RenderSettings are traced scalars streamed to the device each
step, the analog of the reference's runtime-tunable StreamableTensors
(reference: src/PathTracerApp.hpp:107-115 - seed, aa-scale, fov, azimuth,
sample limit).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp


class StaticConfig(NamedTuple):
    """Compile-time render configuration."""

    width: int = 256
    height: int = 256
    max_path_length: int = 10  # --max-path-length
    aa_noise_type: str = "normal"  # --aa-noise-type
    # Sample-stream generator: "prng" = independent counter-based
    # uniforms (the analog of the reference's poprand pools,
    # PathTracerApp.cpp:266-299);
    # "sobol" = hash-based Owen-scrambled Sobol (render/qmc.py) on the
    # first ``sobol_dims`` path dimensions with prng padding beyond.
    sampler: str = "prng"
    # How many leading path dimensions ride the Sobol sequence in sobol
    # mode: a multiple of 4 covering the camera dims (AA x2, lens x2)
    # plus whole bounces (4 each).  12 = camera + bounces 0-1, where
    # nearly all of the integrand's variance lives at the default scene
    # (94% of paths escape by bounce 2).  Clipped to 4 + 4*max_path_length.
    sobol_dims: int = 12


class RenderSettings(NamedTuple):
    """Runtime-tunable scalars (traced; no recompile on change).

    samples_per_step is deliberately dynamic - the reference streams the
    on-device sample limit at runtime too (deviceSampleLimit,
    PathTracerApp.cpp:353-355,466-468), so switching between interactive
    and full sampling never recompiles.
    """

    fov: jnp.ndarray  # horizontal field of view, radians
    aa_scale: jnp.ndarray  # anti-alias jitter scale, pixels
    azimuth: jnp.ndarray  # env-map rotation, radians
    refractive_index: jnp.ndarray  # --refractive-index
    stop_prob: jnp.ndarray  # russian roulette stop probability
    roulette_depth: jnp.ndarray  # bounces before roulette starts (int32)
    samples_per_step: jnp.ndarray  # on-device sample loop count (int32)
    # Thin-lens depth of field (an addition; aperture 0 = the
    # reference's pinhole camera).  Runtime-tunable like the rest:
    aperture: jnp.ndarray  # lens radius in scene units
    focal_distance: jnp.ndarray  # focus-plane distance along -z
    # Render-wide Owen-scramble key for --sampler sobol (render/qmc.py).
    # Derived from the CLI seed; MUST stay constant across steps so each
    # pixel walks one continuous scrambled-Sobol sequence.  Unused (but
    # still carried - settings are a fixed pytree) in prng mode.
    sobol_key: jnp.ndarray = 0  # uint32 scalar (int 0 default, weak-typed)

    @staticmethod
    def make(
        fov_degrees: float = 90.0,
        aa_scale: float = 0.3,
        env_rotation_degrees: float = 0.0,
        refractive_index: float = 1.5,
        stop_prob: float = 0.3,
        roulette_depth: int = 3,
        samples_per_step: int = 512,
        aperture: float = 0.0,
        focal_distance: float = 1.0,
        seed: int = 1,
    ) -> "RenderSettings":
        import numpy as np

        return RenderSettings(
            fov=jnp.float32(np.deg2rad(fov_degrees)),
            aa_scale=jnp.float32(aa_scale),
            azimuth=jnp.float32(np.deg2rad(env_rotation_degrees)),
            refractive_index=jnp.float32(refractive_index),
            stop_prob=jnp.float32(stop_prob),
            roulette_depth=jnp.int32(roulette_depth),
            samples_per_step=jnp.int32(samples_per_step),
            aperture=jnp.float32(aperture),
            focal_distance=jnp.float32(focal_distance),
            sobol_key=np.uint32(seed & 0xFFFFFFFF),
        )
