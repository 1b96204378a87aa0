"""On-class quality gate for the int8 NIF chain (VERDICT r4 #1).

Loads the shipped reference-scale asset (assets/urban_alley_synth_nif,
canonical 6x320 trained on synth:urban-alley:2048x4096:seed7), PTQ-
quantises it (models/quant.py), reconstructs the full 2048x4096 frame
with the bf16 and the int8 chain, and scores both against the
generator ground truth with the sweep's own log-domain PSNR
(models/reconstruct.psnr_log).  The decision rule is the r4 one:
the headline may move to a faster arithmetic only if its on-class PSNR
matches the canonical's.

Writes the "quality" section of docs/QUANT.json.

Usage: python scripts/quant_psnr.py [--assets assets/urban_alley_synth_nif]
                                    [--grid 256x512]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import jax
import jax.numpy as jnp

REPO = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, REPO)

from ipu_path_trace_tpu.models.nif import load_nif_assets  # noqa: E402
from ipu_path_trace_tpu.models.quant import (  # noqa: E402
    nif_apply_quant,
    quantize_nif,
)
from ipu_path_trace_tpu.models.reconstruct import reconstruct_image  # noqa: E402
from ipu_path_trace_tpu.models.synth_env import resolve_synth  # noqa: E402
from ipu_path_trace_tpu.models.reconstruct import psnr_log  # noqa: E402

SYNTH = "synth:urban-alley:2048x4096:seed7"


def reconstruct_quant(qparams, h: int, w: int, max_batch: int) -> np.ndarray:
    """Batched full-frame reconstruction with the int8 chain (the quant
    twin of models.reconstruct.reconstruct_image).

    Uses reconstruct's uv_grid (u = k/H): the TRAINING lattice.  A
    half-pixel-offset centre convention here once under-read the int8
    PSNR by ~8 dB (even unquantised f32 reads 28.0 dB off-lattice vs
    36.3 on it) - alignment, not quantisation, dominated the gate.
    Applies reconstruct_image's bgr->rgb flip so the result compares
    channel-consistently against the rgb ground truth: until r5 this
    was missing, and the bgr-vs-rgb comparison charged ~6.5 dB of pure
    channel permutation to the int8 chain (every path scored through
    this helper read ~29 dB regardless of arithmetic)."""
    from ipu_path_trace_tpu.models.reconstruct import uv_grid

    u, v = uv_grid(h, w)
    out = np.empty((h * w, 3), np.float32)
    apply_fn = jax.jit(nif_apply_quant)
    for lo in range(0, h * w, max_batch):
        sl = slice(lo, min(lo + max_batch, h * w))
        out[sl] = np.asarray(apply_fn(qparams, jnp.asarray(u[sl]),
                                      jnp.asarray(v[sl])))
    return out.reshape(h, w, 3)[..., ::-1].copy()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--assets", default=os.path.join(
        REPO, "assets", "urban_alley_synth_nif"))
    ap.add_argument("--grid", default="256x512",
                    help="calibration lattice HxW")
    ap.add_argument("--max-batch", type=int, default=1 << 19)
    args = ap.parse_args()

    src = resolve_synth(SYNTH)  # (2048, 4096, 3) ground truth, bgr order
    h, w = src.shape[:2]
    params, meta, weights = load_nif_assets(args.assets)  # bf16 params

    gh, gw = (int(x) for x in args.grid.split("x"))
    t0 = time.monotonic()
    qp = quantize_nif(weights, meta, grid=(gh, gw))
    t_q = time.monotonic() - t0
    print(f"quantised in {t_q:.1f}s (calibration {gh}x{gw})", file=sys.stderr)

    t0 = time.monotonic()
    rec_bf16 = reconstruct_image(params, h, w, max_batch_size=args.max_batch)
    p_bf16 = psnr_log(rec_bf16, src)
    print(f"bf16 PSNR {p_bf16:.2f} dB ({time.monotonic()-t0:.0f}s)",
          file=sys.stderr)

    t0 = time.monotonic()
    rec_q = reconstruct_quant(qp, h, w, args.max_batch)
    p_q = psnr_log(rec_q, src)
    print(f"int8 PSNR {p_q:.2f} dB ({time.monotonic()-t0:.0f}s)",
          file=sys.stderr)

    path = os.path.join(REPO, "docs", "QUANT.json")
    doc = {}
    if os.path.exists(path):
        with open(path) as f:
            doc = json.load(f)
    doc["quality"] = {
        "asset": os.path.relpath(args.assets, REPO),
        "env": SYNTH,
        "metric": "psnr_log_db (models/reconstruct.psnr_log), full frame",
        "calibration_grid": f"{gh}x{gw}",
        "bf16_psnr_db": round(p_bf16, 2),
        "int8_psnr_db": round(p_q, 2),
    }
    with open(path, "w") as f:
        json.dump(doc, f, indent=2)
    print(json.dumps(doc["quality"]))


if __name__ == "__main__":
    main()
