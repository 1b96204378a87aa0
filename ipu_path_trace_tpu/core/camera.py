"""Pinhole camera and anti-aliasing jitter.

Equivalent of the ``GenerateCameraRays`` codelet
(reference: src/codelets/codelets.cpp:36-80) and the AA-noise generators
(reference: src/PathTracerApp.cpp:29-45).

``light::pixelToRay`` is reconstructed from the reference's smallpaint
lineage: pixel -> un-normalised direction with implicit z = -1; the ray
constructor normalises.  The horizontal field of view is given in radians
and maps the image width onto tan(fov/2); the vertical scale uses the
aspect-scaled angle tan((h/w) * fov/2) as in smallpaint's camcr().
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .vecmath import Vec3

AA_NOISE_TYPES = ("uniform", "normal", "truncated-normal")


def pixel_to_ray(col, row, width: int, height: int, fov) -> Vec3:
    """Map (possibly fractional) pixel coords to an unnormalised camera ray.

    col/row: arrays of pixel coordinates (origin top-left).
    Returns direction (x, y, -1), not normalised
    (cf. codelets.cpp:73-75 where only x, y are stored and z = -1 is
    implicit; normalisation happens when the ray is constructed,
    codelets.cpp:162-163).
    """
    w = jnp.asarray(float(width), col.dtype)
    h = jnp.asarray(float(height), col.dtype)
    half_fov = fov * 0.5
    x = ((2.0 * col - w) / w) * jnp.tan(half_fov)
    y = -((2.0 * row - h) / h) * jnp.tan((h / w) * half_fov)
    return Vec3(x, y, jnp.full_like(x, -1.0))


def aa_noise(key: jax.Array, shape, noise_type: str = "normal", dtype=jnp.float32):
    """Anti-aliasing jitter in pixel units (PathTracerApp.cpp:29-45).

    - "uniform":          U[-1, 1)
    - "normal":           N(0, 1)
    - "truncated-normal": N(0, 1) truncated at +/- 3 sigma
                          (poprand::truncatedNormal with alpha=3)
    """
    if noise_type == "uniform":
        return jax.random.uniform(key, shape, dtype, minval=-1.0, maxval=1.0)
    if noise_type == "normal":
        return jax.random.normal(key, shape, dtype)
    if noise_type == "truncated-normal":
        return jax.random.truncated_normal(key, -3.0, 3.0, shape, dtype)
    raise ValueError(f"Invalid AA noise type: {noise_type!r} (expected one of {AA_NOISE_TYPES})")
