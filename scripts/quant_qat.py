"""QAT fine-tune of the shipped reference-scale NIF for the int8 chain.

PTQ loses on-class PSNR (scripts/quant_psnr.py), so this re-fits the canonical 6x320 THROUGH the exact inference
quantiser (models/quant.qat_finetune: STE fake-quant on features,
per-channel weights, and the fixed calibrated activation grids), then
scores the resulting int8 chain against the ground truth with the
sweep's full-frame log-PSNR.

The decision rule: the headline moves to int8 only if its on-class
PSNR matches the canonical bf16's.  Whatever the outcome, the numbers land in
docs/QUANT.json "qat"; a passing run also writes the asset directory
(converted.hdf5 + nif_metadata.txt + quant_amax.json with the
activation grids the fine-tune trained against).

Usage: python scripts/quant_qat.py [--epochs 3000] [--lr 2e-4]
           [--out assets/urban_alley_synth_nif_int8] [--save-always]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, REPO)

from ipu_path_trace_tpu.models.nif import load_nif_assets  # noqa: E402
from ipu_path_trace_tpu.models.quant import (  # noqa: E402
    qat_finetune,
    quantize_nif,
)
from ipu_path_trace_tpu.models.synth_env import resolve_synth  # noqa: E402
from ipu_path_trace_tpu.models.reconstruct import psnr_log  # noqa: E402
from scripts.quant_psnr import reconstruct_quant  # noqa: E402

SYNTH = "synth:urban-alley:2048x4096:seed7"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--assets", default=os.path.join(
        REPO, "assets", "urban_alley_synth_nif"))
    ap.add_argument("--out", default=os.path.join(
        REPO, "assets", "urban_alley_synth_nif_int8"))
    ap.add_argument("--epochs", type=int, default=3000)
    ap.add_argument("--batch-size", type=int, default=65536)
    ap.add_argument("--train-samples", type=int, default=131072)
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--grid", default="256x512")
    ap.add_argument("--max-batch", type=int, default=1 << 19)
    ap.add_argument("--save-always", action="store_true",
                    help="write the asset even if the gate fails")
    args = ap.parse_args()

    src = resolve_synth(SYNTH)
    h, w = src.shape[:2]
    params, meta, weights = load_nif_assets(args.assets)
    gh, gw = (int(x) for x in args.grid.split("x"))

    t0 = time.monotonic()
    new_weights, amax, loss = qat_finetune(
        weights, meta, src,
        epochs=args.epochs, batch_size=args.batch_size,
        train_samples=args.train_samples, learning_rate=args.lr,
        calib_grid=(gh, gw), seed=args.seed)
    t_train = time.monotonic() - t0
    print(f"QAT {args.epochs} epochs in {t_train:.0f}s, loss {loss:.6f}",
          file=sys.stderr)

    qp = quantize_nif(new_weights, meta, amax=amax)
    t0 = time.monotonic()
    rec = reconstruct_quant(qp, h, w, args.max_batch)
    p_qat = psnr_log(rec, src)
    print(f"QAT int8 PSNR {p_qat:.2f} dB ({time.monotonic()-t0:.0f}s)",
          file=sys.stderr)

    # Also score with amax RE-calibrated from the fine-tuned weights, to
    # learn whether the sidecar grids are load-bearing at inference.
    qp_recal = quantize_nif(new_weights, meta, grid=(gh, gw))
    p_recal = psnr_log(reconstruct_quant(qp_recal, h, w, args.max_batch), src)
    print(f"QAT int8 PSNR (recalibrated amax) {p_recal:.2f} dB",
          file=sys.stderr)

    path = os.path.join(REPO, "docs", "QUANT.json")
    doc = {}
    if os.path.exists(path):
        with open(path) as f:
            doc = json.load(f)
    gate = doc.get("quality", {}).get("bf16_psnr_db")
    entry = {
        "epochs": args.epochs,
        "batch_size": args.batch_size,
        "train_samples": args.train_samples,
        "learning_rate": args.lr,
        "train_seconds": round(t_train, 1),
        "final_loss": loss,
        "int8_psnr_db": round(p_qat, 2),
        "int8_psnr_recalibrated_db": round(p_recal, 2),
        "gate_bf16_psnr_db": gate,
        "passes_gate": bool(gate is not None and p_qat >= gate),
    }
    doc["qat"] = entry
    with open(path, "w") as f:
        json.dump(doc, f, indent=2)
    print(json.dumps(entry))

    if entry["passes_gate"] or args.save_always:
        from ipu_path_trace_tpu.models.train_nif import save_assets

        cmd = ["python", "scripts/quant_qat.py",
               "--epochs", str(args.epochs),
               "--batch-size", str(args.batch_size),
               "--train-samples", str(args.train_samples),
               "--lr", str(args.lr), "--seed", str(args.seed),
               "--grid", args.grid, "--save-always"]
        save_assets(args.out, new_weights, meta, cmd)
        with open(os.path.join(args.out, "quant_amax.json"), "w") as f:
            json.dump({"amax": [float(a) for a in amax],
                       "calibration_grid": f"{gh}x{gw}"}, f, indent=2)
        print(f"wrote {args.out}", file=sys.stderr)


if __name__ == "__main__":
    main()
