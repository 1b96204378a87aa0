"""Where does the int8 PTQ quality loss come from?

Full int8 PTQ of the shipped 6x320 loses on-class PSNR against bf16
(scripts/quant_psnr.py).  Before spending a QAT budget, isolate which of the three quantisation
points costs what, by running the int8 chain with each point
quantised ALONE (the rest f32):

* ``feats``   - input Fourier features snapped to the constant 1/127
                grid (irreversible input information loss: the floor no
                amount of weight adaptation can cross);
* ``weights`` - per-output-channel int8 weights, f32 activations;
* ``acts``    - post-ReLU activations requantised on the calibrated
                per-layer grids, f32 weights and features.

Writes the "ablation" section of docs/QUANT.json.  The feats-only PSNR
upper-bounds what int8 QAT of this arch can reach (QAT adapts weights,
not the input grid), so it decides whether fine-tuning is worth a run.

Usage: python scripts/quant_ablation.py [--grid 256x512] [--eval-grid 1024x2048]
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
    AQMAX,
    QMAX,
    _f32_chain_activations,
    calibration_features,
)
from ipu_path_trace_tpu.models.synth_env import resolve_synth  # noqa: E402
from ipu_path_trace_tpu.models.nif import nif_encode  # noqa: E402
from ipu_path_trace_tpu.models.reconstruct import psnr_log  # noqa: E402

SYNTH = "synth:urban-alley:2048x4096:seed7"


def selective_apply(weights, meta, u, v, *, q_feats, q_weights, q_acts, amax):
    """f32 NIF forward with each quantisation point individually
    toggleable.  With all three on this is models/quant.nif_apply_quant
    up to f32-vs-i32 accumulator rounding (f32 holds int products of
    this size exactly; the dot ORDER differs, so only ~1 ulp apart)."""
    feats = nif_encode(u, v, meta.embedding_dimension, jnp.float32).T  # (P, 4E)
    if q_feats:
        feats = jnp.round(jnp.clip(feats, -1, 1) * QMAX) / QMAX
    x = feats
    nl = len(weights.layers)
    for i, l in enumerate(weights.layers):
        w = jnp.asarray(l.kernel, jnp.float32)
        if q_weights:
            sw = jnp.maximum(jnp.abs(w).max(axis=0), 1e-12) / QMAX
            w = jnp.clip(jnp.round(w / sw), -QMAX, QMAX) * sw
        if x.shape[-1] != w.shape[0]:
            x = jnp.concatenate([x, feats], axis=-1)
        y = x @ w
        if l.bias is not None:
            y = y + jnp.asarray(l.bias, jnp.float32)
        if i < nl - 1:
            y = jnp.maximum(y, 0.0)
            if q_acts:
                # Asymmetric inference grid: 256 levels over [0, a_i]
                # (models/quant.py quant_layer_t requant + bias fold).
                step = amax[i] / AQMAX
                y = jnp.clip(jnp.round(y / step), 0, AQMAX) * step
        x = y
    y = x * meta.max + jnp.asarray(meta.mean, jnp.float32)
    return jnp.exp(y) if meta.log_tone_map else y


def reconstruct(weights, meta, h, w, max_batch, stride=1, **flags):
    """Evaluate at the ORIGINAL frame's training lattice, strided.  The
    trainer maps pixel k to uv k/H (train_nif.py uv grid; reconstruct's
    uv_grid matches), so the strided ground truth src[::s, ::s] lives at
    (k*s)/H.  Even a half-pixel offset costs ~8 dB on this content
    (measured: centre-convention eval reads 28.0 dB where the aligned
    full frame reads 36.3) and would mask every quantisation effect."""
    uu = (np.arange(h, dtype=np.float32) * stride) / (h * stride)
    vv = (np.arange(w, dtype=np.float32) * stride) / (w * stride)
    u, v = [g.reshape(-1) for g in np.meshgrid(uu, vv, indexing="ij")]
    out = np.empty((h * w, 3), np.float32)
    fn = jax.jit(lambda u, v: selective_apply(weights, meta, u, v, **flags))
    for lo in range(0, h * w, max_batch):
        sl = slice(lo, min(lo + max_batch, h * w))
        out[sl] = np.asarray(fn(jnp.asarray(u[sl]), jnp.asarray(v[sl])))
    return out.reshape(h, w, 3)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--assets", default=os.path.join(
        REPO, "assets", "urban_alley_synth_nif"))
    ap.add_argument("--grid", default="256x512")
    ap.add_argument("--eval-grid", default="1024x2048",
                    help="PSNR evaluation resolution (subsampled ground "
                         "truth; relative ordering is what matters here)")
    ap.add_argument("--max-batch", type=int, default=1 << 19)
    args = ap.parse_args()

    src = resolve_synth(SYNTH)
    eh, ew = (int(x) for x in args.eval_grid.split("x"))
    stride = src.shape[0] // eh
    src_eval = src[::stride, ::stride][:eh, :ew]
    if src.shape[1] // ew != stride:
        raise SystemExit("eval grid must subsample H and W equally")

    params, meta, weights = load_nif_assets(args.assets)
    gh, gw = (int(x) for x in args.grid.split("x"))
    amax = _f32_chain_activations(
        weights, calibration_features(meta.embedding_dimension, (gh, gw)))

    cases = {
        "f32": dict(q_feats=False, q_weights=False, q_acts=False),
        "feats": dict(q_feats=True, q_weights=False, q_acts=False),
        "weights": dict(q_feats=False, q_weights=True, q_acts=False),
        "acts": dict(q_feats=False, q_weights=False, q_acts=True),
        "full": dict(q_feats=True, q_weights=True, q_acts=True),
    }
    out = {"eval_grid": f"{eh}x{ew}", "calibration_grid": f"{gh}x{gw}"}
    for name, flags in cases.items():
        t0 = time.monotonic()
        rec = reconstruct(weights, meta, eh, ew, args.max_batch,
                          stride=stride, amax=amax, **flags)
        p = psnr_log(rec, src_eval)
        out[name + "_psnr_db"] = round(p, 2)
        print(f"{name:8s} {p:6.2f} dB ({time.monotonic()-t0:.0f}s)",
              file=sys.stderr)

    path = os.path.join(REPO, "docs", "QUANT.json")
    doc = {}
    if os.path.exists(path):
        with open(path) as f:
            doc = json.load(f)
    doc["ablation"] = out
    with open(path, "w") as f:
        json.dump(doc, f, indent=2)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
