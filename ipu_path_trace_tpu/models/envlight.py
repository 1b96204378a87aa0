"""Environment lights: constant colour, equirect HDR texture, or NIF MLP.

The reference defers all environment lighting of escaped rays to a
batched lookup after the trace loop (PreProcess -> NIF -> PostProcess,
reference: src/codelets/codelets.cpp:312-385), so the whole escaped-ray
batch runs the NIF as one large batched matmul chain.  Dispatch over
env-light type is static (by python type), so each variant
jit-specialises.

All variants return RGB.  The NIF variant reverses the network's channel
order exactly as PostProcessEscapedRays does (codelets.cpp:377-378).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import jax.numpy as jnp

from ..core.vecmath import Vec3
from .nif import NifParams, nif_apply


class ConstantEnv(NamedTuple):
    """Uniform environment radiance (the minimal end-to-end slice)."""

    colour: Any  # (3,) float32 RGB


class TextureEnv(NamedTuple):
    """Equirectangular HDR texture lookup.

    u indexes rows (theta), v indexes columns (phi) - the same (u, v)
    convention the NIF is trained with (NifModel.cpp:474-490:
    u = row/height, v = col/width).
    """

    texture: Any  # (H, W, 3) float32 RGB
    bilinear: Any = None  # None -> nearest; anything else -> bilinear


class NifEnv(NamedTuple):
    """Neural Image Field environment light (weights as a pytree).

    ``params`` is a NifParams (bf16/f32 chain) or a QuantNifParams
    (models/quant.py int8 chain, --nif-precision int8); every consumer
    dispatches on the pytree type.
    """

    params: NifParams


def _nif_apply(params, u, v):
    """NIF evaluation -> (P, 3), dispatched on the param type."""
    from .quant import QuantNifParams, nif_apply_quant

    if isinstance(params, QuantNifParams):
        return nif_apply_quant(params, u, v)
    return nif_apply(params, u, v)


def eval_env(env, u: jnp.ndarray, v: jnp.ndarray) -> Vec3:
    """Evaluate environment radiance at equirect (u, v) in [0, 1]."""
    if isinstance(env, ConstantEnv):
        c = jnp.asarray(env.colour, jnp.float32)
        ones = jnp.ones_like(u)
        return Vec3(c[0] * ones, c[1] * ones, c[2] * ones)
    if isinstance(env, TextureEnv):
        return _eval_texture(env, u, v)
    if isinstance(env, NifEnv):
        # The network emits its native channel order; reverse it (bgr ->
        # rgb) exactly as PostProcessEscapedRays (codelets.cpp:377-378).
        out = _nif_apply(env.params, u, v)  # (P, 3)
        return Vec3(out[:, 2], out[:, 1], out[:, 0])
    raise TypeError(f"Unknown environment light type: {type(env)!r}")


def bake_nif_env(
    env: NifEnv,
    height: int = 2048,
    width: int = 4096,
    max_batch_size: int = 30 * 1472,
) -> TextureEnv:
    """Decode the NIF once into an equirect texture.

    The reference evaluates the MLP inside the render loop because an
    IPU tile cannot hold the decoded HDRI - compressing it into ~1 MB of
    weights IS the point there (README.md:7-12).  An accelerator with
    tens of GB of device memory can instead decode once (~8.4M evals,
    the cost of ~8 render samples) and serve escaped rays with bilinear
    lookups.  Azimuth rotation needs no re-bake - it enters through
    equirect_uv before the lookup, exactly as it enters the NIF's input.

    The grid is laid on the lookup lattice (u_k = k/(h-1)) so
    eval_env(TextureEnv) reproduces eval_env(NifEnv) exactly at lattice
    points and bilinearly in between.  Selected with --nif-mode=baked;
    the default remains the fused in-loop MLP for reference parity.
    """
    import numpy as np
    import jax

    # Serialise by row blocks (the --max-nif-batch-size strategy of
    # PathTracerApp.cpp:146-164, wired from Config.max_nif_batch_size by
    # runtime/app.py): an unbatched 2048x4096 bake would materialise
    # ~(8.4M, hidden) activations per layer.
    rows_per_chunk = max(1, max_batch_size // width)
    cols_v = jnp.tile(jnp.linspace(0.0, 1.0, width), rows_per_chunk)
    out_np = np.empty((height, width, 3), np.float32)
    apply = jax.jit(_nif_apply)
    for r0 in range(0, height, rows_per_chunk):
        r1 = min(r0 + rows_per_chunk, height)
        rows_u = jnp.repeat(
            jnp.arange(r0, r1, dtype=jnp.float32) / (height - 1), width
        )
        v = cols_v[: (r1 - r0) * width]
        chunk = apply(env.params, rows_u, v)[:, ::-1]
        out_np[r0:r1] = np.asarray(chunk).reshape(r1 - r0, width, 3)
    return TextureEnv(texture=jnp.asarray(out_np), bilinear=True)


def _eval_texture(env: TextureEnv, u, v) -> Vec3:
    tex = env.texture
    h, w = tex.shape[0], tex.shape[1]
    rf = jnp.clip(u, 0.0, 1.0) * (h - 1)
    cf = jnp.clip(v, 0.0, 1.0) * (w - 1)
    if env.bilinear is not None:
        r0 = jnp.floor(rf).astype(jnp.int32)
        c0 = jnp.floor(cf).astype(jnp.int32)
        r1 = jnp.minimum(r0 + 1, h - 1)  # clamp at the poles
        c1 = jnp.mod(c0 + 1, w)  # azimuth is periodic: wrap the phi seam
        ar = (rf - r0)[:, None]
        ac = (cf - c0)[:, None]
        t00 = tex[r0, c0]
        t01 = tex[r0, c1]
        t10 = tex[r1, c0]
        t11 = tex[r1, c1]
        rgb = (
            t00 * (1 - ar) * (1 - ac)
            + t01 * (1 - ar) * ac
            + t10 * ar * (1 - ac)
            + t11 * ar * ac
        )
    else:
        r0 = jnp.clip(jnp.round(rf).astype(jnp.int32), 0, h - 1)
        c0 = jnp.clip(jnp.round(cf).astype(jnp.int32), 0, w - 1)
        rgb = tex[r0, c0]
    return Vec3(rgb[:, 0], rgb[:, 1], rgb[:, 2])
