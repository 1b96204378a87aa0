"""Edge-avoiding à-trous wavelet denoiser with primary-hit guide buffers.

An extension beyond the reference's feature set (the reference
saves the raw Monte-Carlo film only): low-spp previews and bounded-time
renders are cleaned with the standard real-time path-tracing filter —
the edge-avoiding à-trous wavelet transform (Dammertz et al., HPG 2010,
the spatial core of SVGF) — guided by deterministic primary-hit feature
buffers so geometry and texture edges survive.

Design:

- **Guides are free and deterministic.**  ``primary_features`` casts one
  jitter-free pixel-centre ray per pixel through the exact production
  camera (``core.camera.pixel_to_ray``) and intersection
  (``core.geometry.intersect_scene``) code, yielding albedo, shading
  normal, and disparity (1/(1+depth), which compresses the sky to 0)
  per pixel.  No change to the render kernels and no extra per-sample
  state — unlike SVGF there is no temporal accumulation to manage,
  because the progressive film already integrates over steps.
- **Albedo demodulation** divides the radiance by the primary albedo
  before filtering and multiplies it back after, so texture detail is
  not smoothed; non-diffuse and escaped primaries use albedo 1 (their
  radiance is not separable).
- **The filter itself is pure XLA** (static 5x5 B3-spline taps x
  ``iterations`` dyadic dilations, edge-replicated shifts, per-pixel
  weight products) so it jits onto the accelerator and runs on the device film
  where the HDR already lives; the same function runs on the CPU
  backend for host films.

The filter is a pure post-process on the saved image: the accumulator
is untouched, so progressive refinement stays unbiased and a later save
at higher spp starts from the true Monte-Carlo state (reference save
semantics: src/AccumulatedImage.cpp:48-56).

CLI: ``--denoise [--denoise-iters N]``.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

# 1D B3-spline kernel of the à-trous wavelet transform (Dammertz 2010).
_B3 = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)

# Disparity assigned to escaped (sky) primaries: 1/(1+t) with t -> inf.
_SKY_DISPARITY = 0.0


def _cpu_device():
    """Guide/filter compute is pinned to the host CPU backend: the save
    path runs on the async host thread while the device renders, and
    must not contend with the render loop."""
    return jax.local_devices(backend="cpu")[0]


def primary_features(scene, width: int, height: int, fov,
                     env=None, azimuth: float = 0.0,
                     max_batch: int = 200_000):
    """Deterministic per-pixel guide buffers from pixel-centre rays.

    Returns dict of float32 numpy arrays:
      albedo    (H, W, 3)  primary-hit colour for DIFFUSE hits; the env
                           radiance along the centre ray for ESCAPED
                           pixels (when ``env`` is given); else 1
      normal    (H, W, 3)  unit shading normal (escaped: the ray dir)
      disparity (H, W)     1 / (1 + hit distance); 0 for sky

    The env-as-albedo trick is what preserves environment detail: an
    escaped primary's converged value IS env(direction) (a deterministic
    quantity — the render only adds AA-kernel integration), so
    demodulating by it flattens the sky before filtering and restores
    the texture bit-sharp after.  ``azimuth`` is the env rotation in
    radians (RenderSettings.azimuth); ``max_batch`` bounds the NIF
    evaluation chunk (the --max-nif-batch-size analog).

    fov is in radians (the camera convention of render/wavefront.py:345).
    Uses the pinhole centre ray even under thin-lens DoF — guides only
    steer filter weights, and the in-focus geometry is what must be
    preserved.
    """
    from ..core.camera import pixel_to_ray
    from ..core.envmap import equirect_uv
    from ..core.geometry import intersect_scene
    from ..core.scene import Material
    from ..core.vecmath import Vec3

    def features(scene):
        v, u = jnp.meshgrid(
            jnp.arange(height, dtype=jnp.float32),
            jnp.arange(width, dtype=jnp.float32),
            indexing="ij",
        )
        d = pixel_to_ray(u.ravel(), v.ravel(), width, height,
                         jnp.float32(fov)).normalized()
        hit = intersect_scene(scene, Vec3.zeros(d.x.shape), d)
        diffuse = hit.valid & (hit.material == int(Material.DIFFUSE))
        one = jnp.ones_like(hit.colour.x)
        albedo = jnp.stack(
            [jnp.where(diffuse, hit.colour.x, one),
             jnp.where(diffuse, hit.colour.y, one),
             jnp.where(diffuse, hit.colour.z, one)], axis=-1)
        normal = jnp.stack(
            [jnp.where(hit.valid, hit.normal.x, d.x),
             jnp.where(hit.valid, hit.normal.y, d.y),
             jnp.where(hit.valid, hit.normal.z, d.z)], axis=-1)
        disparity = jnp.where(hit.valid, 1.0 / (1.0 + hit.t), _SKY_DISPARITY)
        uv = equirect_uv(d, jnp.float32(azimuth))
        return albedo, normal, disparity, hit.valid, uv[0], uv[1]

    cpu = _cpu_device()
    scene = jax.device_put(scene, cpu)
    albedo, normal, disparity, valid, eu, ev = jax.jit(features)(scene)
    albedo = np.array(albedo)  # writable copy (np.asarray of a jax array is read-only)
    if env is not None:
        from ..models.envlight import eval_env

        env = jax.device_put(env, cpu)
        sky = ~np.asarray(valid)
        idx = np.nonzero(sky)[0]
        eu_np, ev_np = np.asarray(eu), np.asarray(ev)
        rad = np.empty((len(idx), 3), np.float32)
        fn = jax.jit(lambda e, a, b: eval_env(e, a, b))
        for s in range(0, len(idx), max_batch):
            sel = idx[s:s + max_batch]
            r = fn(env, jnp.asarray(eu_np[sel]), jnp.asarray(ev_np[sel]))
            rad[s:s + max_batch] = np.stack(
                [np.asarray(r.x), np.asarray(r.y), np.asarray(r.z)], -1)
        albedo[idx] = rad
    return {
        "albedo": albedo.reshape(height, width, 3),
        "normal": np.asarray(normal).reshape(height, width, 3),
        "disparity": np.asarray(disparity).reshape(height, width),
        # Extras for --debug-view (film/debugview.py); the filter itself
        # only reads the three guide buffers above:
        "escape_uv": np.stack([np.asarray(eu), np.asarray(ev)],
                              axis=-1).reshape(height, width, 2),
        "hit": np.asarray(valid).reshape(height, width),
    }


def _shift(img: jnp.ndarray, dy: int, dx: int) -> jnp.ndarray:
    """Edge-replicated spatial shift (no wrap-around)."""
    h, w = img.shape[0], img.shape[1]
    pad = [(max(dy, 0), max(-dy, 0)), (max(dx, 0), max(-dx, 0))]
    pad += [(0, 0)] * (img.ndim - 2)
    padded = jnp.pad(img, pad, mode="edge")
    return padded[max(-dy, 0):max(-dy, 0) + h, max(-dx, 0):max(-dx, 0) + w]


@partial(jax.jit, static_argnames=("iterations",))
def _atrous(c, normal, disparity, iterations,
            sigma_colour, sigma_normal, sigma_depth):
    lum_w = jnp.asarray([0.2126, 0.7152, 0.0722], c.dtype)

    out = c
    for i in range(iterations):
        step = 1 << i
        # Colour edge-stopping runs on log(1+luminance): HDR-compressive,
        # so Monte-Carlo shot noise (including fireflies at dark pixels)
        # and true radiance edges (a sun disc 100x its sky) land on
        # separable scales, which a linear or relative difference cannot
        # do without a per-pixel variance buffer.
        lum = jnp.log1p(jnp.maximum(out @ lum_w, 0.0))
        # EAW: the colour sigma tightens by 2^-i each pass so later
        # (wider) passes only average across genuinely similar radiance.
        sc2 = (sigma_colour * sigma_colour) * (2.0 ** (-i))
        num = jnp.zeros_like(out)
        den = jnp.zeros_like(lum)
        for ky in range(5):
            for kx in range(5):
                dy = (ky - 2) * step
                dx = (kx - 2) * step
                h = _B3[ky] * _B3[kx]
                cq = _shift(out, dy, dx)
                lq = _shift(lum, dy, dx)
                nq = _shift(normal, dy, dx)
                zq = _shift(disparity, dy, dx)
                dl = lum - lq
                w_c = jnp.exp(-(dl * dl) / sc2)
                ndot = jnp.clip(jnp.sum(normal * nq, axis=-1), 0.0, 1.0)
                w_n = ndot ** sigma_normal
                dz = disparity - zq
                w_z = jnp.exp(-(dz * dz) / (sigma_depth * sigma_depth))
                w = h * w_c * w_n * w_z
                num = num + cq * w[..., None]
                den = den + w
        # Weighted mean of the LINEAR radiance (log only shapes weights),
        # so the filter is mean-preserving under symmetric noise.
        out = num / den[..., None]
    return out


@jax.jit
def _firefly_clamp(c, k):
    """Scale each pixel's rgb so its luminance is <= k x the 3x3
    neighbourhood median luminance (the standard spatial outlier
    suppressor: a firefly is a single-pixel outlier against its
    neighbours; real highlights span several pixels, so their own
    median is bright and they pass through)."""
    lum_w = jnp.asarray([0.2126, 0.7152, 0.0722], c.dtype)
    lum = c @ lum_w
    stack = jnp.stack([_shift(lum, dy, dx)
                       for dy in (-1, 0, 1) for dx in (-1, 0, 1)])
    med = jnp.sort(stack, axis=0)[4]
    cap = k * med + 1e-6
    scale = jnp.minimum(1.0, cap / jnp.maximum(lum, 1e-20))
    return c * scale[..., None]


def denoise_hdr(hdr: np.ndarray, guides: dict, *, iterations: int = 4,
                sigma_colour: float = 1.0, sigma_normal: float = 64.0,
                sigma_depth: float = 0.08,
                firefly_clamp: float = 10.0) -> np.ndarray:
    """Denoise a step-normalised HDR image (H, W, 3) -> same shape/dtype.

    ``guides`` is the dict from :func:`primary_features` for the same
    scene/camera.  Albedo is demodulated before filtering and restored
    after, so texture edges cost nothing.  ``firefly_clamp`` k bounds
    each pixel's luminance to k x its 3x3 neighbourhood median before
    the wavelet pass (0 disables) — rarely-sampled point reflections of
    extreme HDR emitters otherwise survive the edge-stop as 'detail'.
    """
    hdr = np.asarray(hdr, np.float32)
    albedo = np.maximum(guides["albedo"].astype(np.float32), 1e-3)
    demod = hdr / albedo
    cpu = _cpu_device()
    demod = jax.device_put(jnp.asarray(demod), cpu)
    if firefly_clamp > 0.0:
        demod = _firefly_clamp(demod, jnp.float32(firefly_clamp))
    filtered = _atrous(
        demod,
        jax.device_put(jnp.asarray(guides["normal"].astype(np.float32)), cpu),
        jax.device_put(jnp.asarray(guides["disparity"].astype(np.float32)), cpu),
        int(iterations),
        jnp.float32(sigma_colour), jnp.float32(sigma_normal),
        jnp.float32(sigma_depth),
    )
    return np.asarray(filtered) * albedo
