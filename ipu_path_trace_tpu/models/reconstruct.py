"""Standalone NIF evaluation: reconstruct the environment map.

Parity with the reference's streamed-IO NifModel mode
(reference: src/neural_networks/NifModel.cpp:403-509 and SURVEY.md
section 3.4): generate the full UV grid (u = row/height, v = col/width,
NifModel.cpp:474-490), run batched inference with max-batch-size
serialisation (the analog of PathTracerApp.cpp:146-198), decode, and
reassemble the image.  Used to debug/eval NIF models independent of the
renderer.

Run: python -m ipu_path_trace_tpu.models.reconstruct <assets_dir> <out.exr>
"""

from __future__ import annotations

import sys
import time

import numpy as np
import jax
import jax.numpy as jnp

from ..utils.logging import logger
from .nif import NifParams, nif_apply


def psnr_log(img: np.ndarray, ref: np.ndarray, eps: float = 1e-8) -> float:
    """PSNR in the log-radiance domain (the NIF's training target)."""
    a = np.log(np.maximum(img, 0.0) + eps)
    b = np.log(np.maximum(ref, 0.0) + eps)
    mse = float(np.mean((a - b) ** 2))
    peak = float(b.max() - b.min())
    return 10.0 * np.log10(peak * peak / mse)


def uv_grid(height: int, width: int) -> tuple[np.ndarray, np.ndarray]:
    """Row-major UV grid exactly as makeGridCoordsUV (NifModel.cpp:474-490)."""
    rows, cols = np.meshgrid(
        np.arange(height, dtype=np.float32), np.arange(width, dtype=np.float32), indexing="ij"
    )
    return (rows / height).ravel(), (cols / width).ravel()


def reconstruct_image(
    params: NifParams,
    height: int,
    width: int,
    max_batch_size: int = 30 * 1472,
    reverse_channels: bool = True,
) -> np.ndarray:
    """Evaluate the NIF over the full image grid, serialised into batches.

    Batch serialisation picks the smallest divisor count keeping batches
    under max_batch_size (the strategy of PathTracerApp.cpp:146-164).
    reverse_channels applies the renderer's bgr->rgb flip
    (codelets.cpp:377-378) so the output displays correctly.
    """
    u, v = uv_grid(height, width)
    n = u.size
    factor = max(1, -(-n // max_batch_size))
    while n % factor:
        factor += 1
    batch = n // factor
    logger().info(
        "Batch-size serialisation full-size: %d serial-size: %d factor: %d", n, batch, factor
    )

    apply_fn = jax.jit(nif_apply)
    out = np.empty((n, 3), np.float32)
    t0 = time.monotonic()
    for s in range(factor):
        sl = slice(s * batch, (s + 1) * batch)
        out[sl] = np.asarray(apply_fn(params, jnp.asarray(u[sl]), jnp.asarray(v[sl])))
    dt = time.monotonic() - t0
    logger().info("Reconstructed %d samples in %.2fs (%.1f Msamples/s)", n, dt, n / dt / 1e6)
    img = out.reshape(height, width, 3)
    return img[..., ::-1].copy() if reverse_channels else img


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(prog="reconstruct")
    p.add_argument("assets_dir")
    p.add_argument("outfile", help="output image (.exr or .png)")
    p.add_argument("size", nargs="*", type=int, metavar="height width",
                   help="override the metadata image shape")
    p.add_argument("--max-batch-size", type=int, default=30 * 1472,
                   help="NIF batch-serialisation cap (the app's "
                        "--max-nif-batch-size; PathTracerApp.cpp:146-164)")
    args = p.parse_args(argv)
    from ..film.imageio import write_exr, write_png
    from .nif import load_nif_assets

    params, meta, _ = load_nif_assets(args.assets_dir)
    h, w = meta.image_shape[:2]
    if len(args.size) >= 2:
        h, w = args.size[0], args.size[1]
    img = reconstruct_image(params, h, w, max_batch_size=args.max_batch_size)
    if args.outfile.endswith(".png"):
        ldr = np.clip(np.power(np.maximum(img, 0.0), 1 / 2.2) * 255.0, 0, 255).astype(np.uint8)
        write_png(args.outfile, ldr)
    else:
        write_exr(args.outfile, img)
    logger().info("Wrote %s (%dx%d)", args.outfile, w, h)
    return 0


if __name__ == "__main__":
    sys.exit(main())
