"""Equirectangular environment-map projection.

Equivalent of the ``PreProcessEscapedRays`` codelet
(reference: src/codelets/codelets.cpp:312-358): escaped-ray directions
become (u, v) lookups for the environment light (texture or NIF MLP).
"""

from __future__ import annotations

import jax.numpy as jnp

from .vecmath import Vec3

PI = jnp.pi
TWO_PI = 2.0 * jnp.pi


def equirect_uv(direction: Vec3, azimuth_offset):
    """Map unit directions to equirectangular (u, v) in [0, 1].

    theta = acos(y); phi = atan2(z, x) + azimuth, wrapped into [0, 2pi]
    with a single add/subtract exactly as the reference does
    (codelets.cpp:333-344); u = theta/pi, v = phi/2pi.
    """
    y = jnp.clip(direction.y, -1.0, 1.0)
    theta = jnp.arccos(y)
    phi = jnp.arctan2(direction.z, direction.x) + azimuth_offset
    phi = jnp.where(phi < 0.0, phi + TWO_PI, jnp.where(phi > TWO_PI, phi - TWO_PI, phi))
    return theta * (1.0 / PI), phi * (1.0 / TWO_PI)
