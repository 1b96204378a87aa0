"""Ray/scene intersection, vectorised over the wavefront batch.

Equivalent of ``light::Scene::intersect`` as used by the trace
megakernel (reference: src/codelets/codelets.cpp:183).  The per-ray
object loop becomes a broadcast over a (batch, objects) grid with an
argmin; the object count is tiny and static so XLA fully unrolls it.

Intersection math follows the reference's smallpaint lineage:
  sphere: quadratic with b = 2(o-c).d, keep nearest root > eps;
  disc:   plane hit then radius check.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from .scene import Scene
from .vecmath import Vec3

# Self-intersection epsilon. The reference's smallpaint lineage uses
# 1e-6, but float32 ray origins sitting exactly on the surface produce
# false self-hits clustered at t ~ 1e-6, exactly at that threshold -
# making hit/miss a coin-flip on fp rounding. 3e-5 rejects that cluster
# deterministically while staying 3x below the smallest real feature:
# the default scene's clear-coat shell gap of 1e-4 (codelets.cpp:115-116,
# sphere radii 0.4 vs 0.4001), whose hits a larger EPS would reject.
EPS = 3e-5
_INF = jnp.inf


class Hit(NamedTuple):
    """Per-lane intersection result (SoA over the ray batch)."""

    valid: jnp.ndarray  # (P,) bool: ray hit something
    t: jnp.ndarray  # (P,) distance along ray (inf if miss)
    point: Vec3  # (P,) hit position (ray advanced to hit, Scene::intersect semantics)
    normal: Vec3  # (P,) geometric normal at hit
    obj: jnp.ndarray  # (P,) int32 object index (spheres then discs)
    colour: Vec3  # (P,) material colour of hit object
    emission: Vec3  # (P,) emission of hit object
    emissive: jnp.ndarray  # (P,) bool
    material: jnp.ndarray  # (P,) int32 Material enum


def _sphere_t(cx, cy, cz, radius, o: Vec3, d: Vec3):
    """Hit distance for one sphere over the ray batch (inf = miss)."""
    ox = o.x - cx
    oy = o.y - cy
    oz = o.z - cz
    b = 2.0 * (ox * d.x + oy * d.y + oz * d.z)
    c = ox * ox + oy * oy + oz * oz - radius * radius
    disc = b * b - 4.0 * c
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    near = (-b - sq) * 0.5
    far = (-b + sq) * 0.5
    t = jnp.where(near > EPS, near, jnp.where(far > EPS, far, _INF))
    return jnp.where(disc >= 0.0, t, _INF)


def _disc_t(nx, ny, nz, cx, cy, cz, radius, o: Vec3, d: Vec3):
    """Hit distance for one disc over the ray batch (inf = miss)."""
    denom = d.x * nx + d.y * ny + d.z * nz
    num = (cx - o.x) * nx + (cy - o.y) * ny + (cz - o.z) * nz
    t = num / jnp.where(jnp.abs(denom) > 1e-12, denom, 1e-12)
    px = o.x + d.x * t - cx
    py = o.y + d.y * t - cy
    pz = o.z + d.z * t - cz
    inside = px * px + py * py + pz * pz <= radius * radius
    ok = (t > EPS) & inside & (jnp.abs(denom) > 1e-12)
    return jnp.where(ok, t, _INF)


def intersect_scene(scene: Scene, o: Vec3, d: Vec3) -> Hit:
    """Intersect a batch of rays with every object; keep the nearest hit.

    ``d`` must be normalised.  Mirrors ``scene.intersect(ray)`` advancing
    the ray to the hit point (codelets.cpp:183): ``point`` is the new ray
    origin for the next bounce.

    The object loop is unrolled statically with per-lane selects - object
    attributes are compile-time scalars broadcast over the batch, so the
    hot loop contains NO dynamic gathers (the select chain fuses into
    one elementwise kernel).
    """
    num_s = scene.num_spheres
    num_d = scene.disc_radius.shape[0]
    shape = o.x.shape

    best_t = jnp.full(shape, _INF)
    best_obj = jnp.zeros(shape, jnp.int32)
    nrm = Vec3.zeros(shape)
    colour = Vec3.zeros(shape)
    emission = Vec3.zeros(shape)
    emissive = jnp.zeros(shape, bool)
    material = jnp.zeros(shape, jnp.int32)

    def take(k, t_k, n_k, closer_point_normal):
        nonlocal best_t, best_obj, nrm, colour, emission, emissive, material
        closer = t_k < best_t
        best_t = jnp.where(closer, t_k, best_t)
        best_obj = jnp.where(closer, k, best_obj)
        nrm = n_k.where(closer, nrm) if not closer_point_normal else nrm
        colour = Vec3(
            jnp.where(closer, scene.colour[k, 0], colour.x),
            jnp.where(closer, scene.colour[k, 1], colour.y),
            jnp.where(closer, scene.colour[k, 2], colour.z),
        )
        emission = Vec3(
            jnp.where(closer, scene.emission[k, 0], emission.x),
            jnp.where(closer, scene.emission[k, 1], emission.y),
            jnp.where(closer, scene.emission[k, 2], emission.z),
        )
        emissive = jnp.where(closer, scene.emissive[k], emissive)
        material = jnp.where(closer, scene.material[k], material)
        return closer

    # Spheres: normal depends on the hit point; select the winning centre
    # and derive the normal once at the end instead of per candidate.
    win_c = Vec3.zeros(shape)
    won_sphere = jnp.zeros(shape, bool)
    for k in range(num_s):
        cx = scene.sphere_center[k, 0]
        cy = scene.sphere_center[k, 1]
        cz = scene.sphere_center[k, 2]
        t_k = _sphere_t(cx, cy, cz, scene.sphere_radius[k], o, d)
        closer = take(k, t_k, None, closer_point_normal=True)
        win_c = Vec3(
            jnp.where(closer, cx, win_c.x),
            jnp.where(closer, cy, win_c.y),
            jnp.where(closer, cz, win_c.z),
        )
        won_sphere = won_sphere | closer

    for j in range(num_d):
        nx = scene.disc_normal[j, 0]
        ny = scene.disc_normal[j, 1]
        nz = scene.disc_normal[j, 2]
        t_k = _disc_t(
            nx, ny, nz,
            scene.disc_center[j, 0], scene.disc_center[j, 1], scene.disc_center[j, 2],
            scene.disc_radius[j], o, d,
        )
        ones = jnp.ones(shape)
        closer = take(num_s + j, t_k, Vec3(nx * ones, ny * ones, nz * ones),
                      closer_point_normal=False)
        won_sphere = won_sphere & ~closer

    valid = jnp.isfinite(best_t)
    t_safe = jnp.where(valid, best_t, 0.0)
    point = Vec3(o.x + d.x * t_safe, o.y + d.y * t_safe, o.z + d.z * t_safe)

    if num_s:
        n_s = point - win_c
        inv = 1.0 / jnp.sqrt(jnp.maximum(n_s.norm2(), 1e-20))
        nrm = (n_s * inv).where(won_sphere, nrm)

    return Hit(
        valid=valid,
        t=best_t,
        point=point,
        normal=nrm,
        obj=best_obj,
        colour=colour,
        emission=emission,
        emissive=emissive,
        material=material,
    )
