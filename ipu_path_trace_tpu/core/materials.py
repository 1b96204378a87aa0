"""BSDF sampling and russian roulette, vectorised with masked lanes.

Equivalents of ``light::diffuse``, ``light::reflect``,
``light::refract`` and ``light::rouletteWeight`` as consumed by the trace
megakernel (reference: src/codelets/codelets.cpp:173-216).  The math is
reconstructed from the reference's smallpaint lineage (the tell-tale
1.15 refraction weight at codelets.cpp:212 is smallpaint's constant).

Throughput semantics (equivalent to the reference's backward stack walk
in AccumulateContributions, codelets.cpp:261-292, run forwards):
  DIFFUSE   throughput *= colour * (cos_theta * 0.1 * rrFactor)
  SPECULAR  throughput *= rrFactor
  REFRACT   throughput *= tint * (1.15 * rrFactor)
  EMIT      radiance += throughput * emission * rrFactor
  ESCAPED   radiance += throughput * env(dir) * rrFactor
"""

from __future__ import annotations

import jax.numpy as jnp

from .vecmath import Vec3, orthonormal_basis

# smallpaint's diffuse albedo scale (the 0.1 in `cost * 0.1 * rrFactor`):
DIFFUSE_SCALE = 0.1
# smallpaint's refraction boost (codelets.cpp:212):
REFRACT_WEIGHT = 1.15
TWO_PI = 2.0 * jnp.pi


def roulette_weight(rand, stop_prob):
    """Russian roulette: (stop, weight) = light::rouletteWeight(rand, p).

    Stops when rand <= p; surviving rays are compensated by 1/(1-p)
    (codelets.cpp:176-180).
    """
    stop = rand <= stop_prob
    weight = 1.0 / (1.0 - stop_prob)
    return stop, weight


def hemisphere_sample(u1, u2) -> Vec3:
    """Uniform hemisphere sample about +z (smallpaint's `hemisphere`).

    z = u1 (uniform in [0,1)), radius = sqrt(1 - z^2), azimuth = 2 pi u2.
    """
    r = jnp.sqrt(jnp.maximum(1.0 - u1 * u1, 0.0))
    phi = TWO_PI * u2
    return Vec3(jnp.cos(phi) * r, jnp.sin(phi) * r, u1)


def sample_diffuse(normal: Vec3, u1, u2) -> tuple[Vec3, jnp.ndarray]:
    """Sample a new direction for a diffuse bounce.

    Returns (direction, cos_theta).  The caller multiplies throughput by
    colour * cos_theta * DIFFUSE_SCALE * rrFactor (light::diffuse's
    Contribution{colour, cost*0.1*rrFactor, DIFFUSE}).
    """
    t1, t2 = orthonormal_basis(normal)
    s = hemisphere_sample(u1, u2)
    d = t1 * s.x + t2 * s.y + normal * s.z
    cos_theta = d.dot(normal)
    return d, cos_theta


def reflect(d: Vec3, n: Vec3) -> Vec3:
    """Mirror reflection: d - 2 (d.n) n (light::reflect)."""
    k = 2.0 * d.dot(n)
    return d - n * k


def refract(d: Vec3, n: Vec3, refractive_index, rand) -> tuple[Vec3, jnp.ndarray]:
    """Glass interaction with Schlick-approximated Fresnel choice.

    Follows smallpaint's `refract` exactly: flips the normal when the ray
    is inside the medium, picks refraction when cos^2(theta_2) > 0 and
    rand > R(theta), otherwise reflects.  Returns (new_dir, refracted).
    The caller tints by material colour when refracted else leaves the
    throughput untinted (codelets.cpp:210-212).
    """
    n_idx = refractive_index
    r0 = (1.0 - n_idx) / (1.0 + n_idx)
    r0 = r0 * r0
    inside = d.dot(n) > 0.0
    nl = n.where(~inside, -n)  # normal on the incident side
    eta = jnp.where(inside, n_idx, 1.0 / n_idx)  # smallpaint: n=1/n then n=1/n again when inside
    cost1 = -d.dot(nl)
    cost2 = 1.0 - eta * eta * (1.0 - cost1 * cost1)
    # (1 - cost1)^5 via multiplies (exact Schlick):
    p1 = 1.0 - cost1
    p2 = p1 * p1
    rprob = r0 + (1.0 - r0) * (p2 * p2 * p1)
    do_refract = (cost2 > 0.0) & (rand > rprob)
    sqrt_cost2 = jnp.sqrt(jnp.maximum(cost2, 0.0))
    d_refr = (d * eta + nl * (eta * cost1 - sqrt_cost2)).normalized()
    d_refl = (d + nl * (2.0 * cost1)).normalized()
    return d_refr.where(do_refract, d_refl), do_refract
