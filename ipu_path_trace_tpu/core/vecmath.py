"""SoA 3-vector math for the wavefront path tracer.

Vectors are stored as three separate component arrays (structure of
arrays), so every elementwise op runs over the contiguous batch
dimension instead of a strided 3-element axis.

This is the equivalent of ``light::Vector``
(reference: external/light, used throughout src/codelets/codelets.cpp).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp


class Vec3(NamedTuple):
    """A batch of 3-vectors in SoA layout. Works with jnp or np arrays."""

    x: jnp.ndarray
    y: jnp.ndarray
    z: jnp.ndarray

    def __add__(self, o: "Vec3") -> "Vec3":
        return Vec3(self.x + o.x, self.y + o.y, self.z + o.z)

    def __sub__(self, o: "Vec3") -> "Vec3":
        return Vec3(self.x - o.x, self.y - o.y, self.z - o.z)

    def __mul__(self, s) -> "Vec3":
        """Scalar (or per-lane scalar array) multiply."""
        return Vec3(self.x * s, self.y * s, self.z * s)

    __rmul__ = __mul__

    def __neg__(self) -> "Vec3":
        return Vec3(-self.x, -self.y, -self.z)

    def cwise(self, o: "Vec3") -> "Vec3":
        """Componentwise product (``light::Vector::cwiseProduct``)."""
        return Vec3(self.x * o.x, self.y * o.y, self.z * o.z)

    def dot(self, o: "Vec3"):
        return self.x * o.x + self.y * o.y + self.z * o.z

    def cross(self, o: "Vec3") -> "Vec3":
        return Vec3(
            self.y * o.z - self.z * o.y,
            self.z * o.x - self.x * o.z,
            self.x * o.y - self.y * o.x,
        )

    def norm2(self):
        return self.dot(self)

    def normalized(self) -> "Vec3":
        inv = jnp.asarray(1.0) / jnp.sqrt(self.norm2())
        return self * inv

    def where(self, mask, other: "Vec3") -> "Vec3":
        """Select self where mask else other (per lane)."""
        return Vec3(
            jnp.where(mask, self.x, other.x),
            jnp.where(mask, self.y, other.y),
            jnp.where(mask, self.z, other.z),
        )

    @staticmethod
    def full(shape, cx, cy, cz, dtype=jnp.float32) -> "Vec3":
        return Vec3(
            jnp.full(shape, cx, dtype),
            jnp.full(shape, cy, dtype),
            jnp.full(shape, cz, dtype),
        )

    @staticmethod
    def zeros(shape, dtype=jnp.float32) -> "Vec3":
        z = jnp.zeros(shape, dtype)
        return Vec3(z, z, z)

    def astype(self, dtype) -> "Vec3":
        return Vec3(self.x.astype(dtype), self.y.astype(dtype), self.z.astype(dtype))

    def stack(self):
        """Return an (..., 3) dense array (host/debug use)."""
        return jnp.stack([self.x, self.y, self.z], axis=-1)


def orthonormal_basis(n: Vec3) -> tuple[Vec3, Vec3]:
    """Build two tangents orthogonal to unit vectors ``n``.

    Branchless SoA port of the ``ons`` construction used by the reference's
    diffuse BSDF (external/light lineage, cf. smallpaint): pick the
    larger-magnitude of x/y to stabilise the reciprocal length.
    """
    use_x = jnp.abs(n.x) > jnp.abs(n.y)
    # Both branches are evaluated under `where`, so clamp the denominators:
    # the unselected branch may otherwise produce 0 * inf = NaN.
    tiny = jnp.asarray(1e-20, n.x.dtype)
    # Branch a: v2 = (-z, 0, x) / sqrt(x^2+z^2)   (when |x| > |y|)
    inv_a = jnp.asarray(1.0) / jnp.sqrt(jnp.maximum(n.x * n.x + n.z * n.z, tiny))
    va = Vec3(-n.z * inv_a, jnp.zeros_like(n.x), n.x * inv_a)
    # Branch b: v2 = (0, z, -y) / sqrt(y^2+z^2)   (when |x| <= |y|)
    inv_b = jnp.asarray(1.0) / jnp.sqrt(jnp.maximum(n.y * n.y + n.z * n.z, tiny))
    vb = Vec3(jnp.zeros_like(n.x), n.z * inv_b, -n.y * inv_b)
    t1 = va.where(use_x, vb)
    t2 = n.cross(t1)
    return t1, t2
