"""Hash-based Owen-scrambled Sobol sampling (the ``--sampler sobol`` path).

An extension BEYOND the reference, which consumes plain
pseudorandom pools for every dimension (reference:
src/PathTracerApp.cpp:266-299, poprand uniforms).  Monte-Carlo RMSE
converges as N^-0.5 with independent uniforms; an Owen-scrambled Sobol
(0,2)-sequence converges up to N^-1.5 on smooth integrands while staying
provably unbiased.  At the default scene ~65% of pixels are sky whose
integrand is a smooth 2-D function of the AA jitter alone - exactly the
regime where randomised QMC shines.

Construction (Burley, "Practical Hash-based Owen Scrambling", JCGT 2020):

  * per-pixel INDEX shuffle: sample i of pixel p draws Sobol point
    ``nested_uniform_scramble(i, pixel_seed(p))`` - decorrelating pixels
    by shuffling each one's view of the global sequence ("padding"),
  * per-dimension OUTPUT scramble: each dimension's value goes through
    ``nested_uniform_scramble`` with a dimension-keyed seed, breaking
    the raw sequence's bad 2-D projections while preserving its
    elementary-interval stratification (an Owen scramble maps
    (0, m, s)-nets to (0, m, s)-nets),
  * nested_uniform_scramble(x) = reverse_bits(laine_karras(reverse_bits(x)))
    with the Laine-Karras hash as the per-level permutation.

Everything here is 32-bit integer math on jnp arrays - same ints in,
same bits out on every backend - with only constant shift amounts; the
float conversion is (top24 + 1) * 2^-24, in (0, 1].

Direction numbers (Joe & Kuo 2008, via scipy) are baked as Python ints
in render/_sobol_dirs.py - plain data, no runtime scipy dependency.

The per-pixel sample index is the worklist's own per-record
``sample_count`` (reference TraceRecord sampleCount semantics), so the
sequence continues seamlessly across progressive steps, checkpoints
and restarts - each lane resumes at its own index.
"""

from __future__ import annotations

import jax.numpy as jnp

from ._sobol_dirs import DIRS

# Number of camera dims in the noise layout (AA jitter x2, lens x2)
# ahead of the 4-per-bounce dims; see render/wavefront.sample_noise.
CAMERA_DIMS = 4
MAX_DIMS = len(DIRS)

_GOLDEN = 0x9E3779B9  # 2^32 / golden ratio; per-dimension seed salt

# Direction numbers bit-reversed once at import: accumulating with
# reversed tables yields reverse_bits(sobol(x)) directly, saving one
# 5-stage reversal per dimension (the output scramble needs the
# reversed form first anyway).
def _rev32_int(v: int) -> int:
    return int(f"{v:032b}"[::-1], 2)


_REV_DIRS: tuple[tuple[int, ...], ...] = tuple(
    tuple(_rev32_int(v) for v in row) for row in DIRS
)

# sobol_bits_shared's dim-0 shortcut (accumulate == bit-reverse) relies
# on dimension 0 being the van der Corput identity matrix.  Guard it at
# import time so a regenerated direction table can never silently break
# the shortcut (tests exercise it, but only when scipy is installed).
if not all(DIRS[0][k] == (0x80000000 >> k) for k in range(32)):
    # Explicit raise (not a bare assert) so the guard survives python -O.
    raise AssertionError(
        "Sobol dimension 0 must be the van der Corput identity matrix")


def reverse_bits32(x: jnp.ndarray) -> jnp.ndarray:
    """Bit-reverse each lane of a uint32 vector (5-stage butterfly)."""
    x = ((x & 0x55555555) << 1) | ((x >> 1) & 0x55555555)
    x = ((x & 0x33333333) << 2) | ((x >> 2) & 0x33333333)
    x = ((x & 0x0F0F0F0F) << 4) | ((x >> 4) & 0x0F0F0F0F)
    x = ((x & 0x00FF00FF) << 8) | ((x >> 8) & 0x00FF00FF)
    return (x << 16) | (x >> 16)


def lowbias32(x: jnp.ndarray) -> jnp.ndarray:
    """Wellons' lowbias32 integer hash (constant shifts only)."""
    x ^= x >> 16
    x *= jnp.uint32(0x7FEB352D)
    x ^= x >> 15
    x *= jnp.uint32(0x846CA68B)
    x ^= x >> 16
    return x


def laine_karras(x: jnp.ndarray, seed) -> jnp.ndarray:
    """Laine-Karras hash: a random base-2 Owen scramble of the REVERSED
    input (each operation only propagates information upward, so after
    un-reversing, bit k depends only on bits above it - the Owen tree
    property).  Constants from Burley (JCGT 2020)."""
    x += seed
    x ^= x * jnp.uint32(0x6C50B47C)
    x ^= x * jnp.uint32(0xB82F1E52)
    x ^= x * jnp.uint32(0xC7AFE638)
    x ^= x * jnp.uint32(0x8D22F6E6)
    return x


def pixel_seed(pixel_id: jnp.ndarray, key) -> jnp.ndarray:
    """Per-pixel index-shuffle seed from the integer pixel id and the
    render-wide sobol key (uint32 scalar or traced scalar)."""
    return lowbias32(pixel_id.astype(jnp.uint32) + jnp.uint32(key))


def dim_seed(key, dim: int):
    """Per-dimension output-scramble seed (scalar; ``dim`` is static)."""
    return lowbias32(jnp.uint32(key) + jnp.uint32((dim * _GOLDEN) & 0xFFFFFFFF))


def scrambled_index_word(idx: jnp.ndarray, pix_seed: jnp.ndarray) -> jnp.ndarray:
    """laine_karras(reverse_bits(i), seed): the shuffled sample index in
    BIT-REVERSED form.  Bit k (LSB-first) of the logical shuffled index
    is bit (31-k) of this word, which is exactly how sobol_bits consumes
    it - the final un-reversal is never materialised."""
    return laine_karras(reverse_bits32(idx.astype(jnp.uint32)), pix_seed)


def sobol_masks(h: jnp.ndarray) -> tuple:
    """The 32 per-bit all-ones/all-zeros masks of ``h`` (mask[k] is
    0xFFFFFFFF when bit 31-k of h is set; 0 - 1 wraps).  They depend on
    the shuffled index alone, NOT the dimension, so every dimension's
    sobol_bits accumulation shares one set - computing them once per
    sample instead of per dimension amortises the dominant QMC cost
    (32x[shift+and+sub]) across all dims.  Pure uint32 ops
    throughout."""
    one = jnp.uint32(1)
    zero = jnp.uint32(0)
    return tuple(zero - ((h >> (31 - k)) & one) for k in range(32))


def sobol_bits_shared(h: jnp.ndarray, masks: tuple, dim: int) -> jnp.ndarray:
    """sobol_bits with the per-bit masks hoisted out (see sobol_masks).

    Dimension 0's direction matrix is the identity (van der Corput:
    DIRS[0][k] == 0x80000000 >> k, asserted at import time above), so
    its reversed-domain accumulation is literally a bit reversal of h -
    15 ops instead of 32 and+xor pairs.
    """
    if dim == 0:
        return reverse_bits32(h)
    rd = _REV_DIRS[dim]
    acc = masks[0] & jnp.uint32(rd[0])
    for k in range(1, 32):
        acc = acc ^ (masks[k] & jnp.uint32(rd[k]))
    return acc


def sobol_bits(h: jnp.ndarray, dim: int) -> jnp.ndarray:
    """reverse_bits(sobol_dim(shuffled_index)) as uint32.

    ``h`` is scrambled_index_word's output; ``dim`` is static.  Uses the
    bit-reversed direction table, so the XOR accumulation lands directly
    in the reversed domain the output scramble wants.  One-dimension
    convenience form; multi-dim consumers share masks via
    sobol_masks/sobol_bits_shared (bit-identical: same XOR terms).
    """
    return sobol_bits_shared(h, sobol_masks(h), dim)


def owen_bits(idx: jnp.ndarray, pix_seed: jnp.ndarray, key, dim: int) -> jnp.ndarray:
    """Owen-scrambled Sobol value for one dimension, as uint32 bits."""
    h = scrambled_index_word(idx, pix_seed)
    return reverse_bits32(laine_karras(sobol_bits(h, dim), dim_seed(key, dim)))


def bits_to_unit(bits: jnp.ndarray) -> jnp.ndarray:
    """uint32 bits -> float32 in (0, 1], 24-bit mantissa."""
    top24 = (bits >> 8).astype(jnp.int32)
    return (top24.astype(jnp.float32) + 1.0) * (1.0 / (1 << 24))


def sobol_uniforms(
    idx: jnp.ndarray,  # (n,) int32/uint32 per-lane sample indices
    pixel_id: jnp.ndarray,  # (n,) int32 per-lane pixel ids (v*width + u)
    key,  # uint32 scalar render-wide sobol key (static across steps!)
    dims: range | tuple,  # static dimension numbers to emit
) -> list[jnp.ndarray]:
    """One (n,) float32 vector in (0, 1] per requested dimension
    (scrambled_index_word and the bit masks are shared across dims).
    """
    ps = pixel_seed(pixel_id, key)
    h = scrambled_index_word(idx, ps)
    masks = sobol_masks(h)
    out = []
    for d in dims:
        bits = reverse_bits32(
            laine_karras(sobol_bits_shared(h, masks, d), dim_seed(key, d)))
        out.append(bits_to_unit(bits))
    return out
