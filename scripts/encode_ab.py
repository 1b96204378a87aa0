"""A/B the int8 chain's double-angle Fourier encode against direct trig.

The int8 chain encodes with a double-angle recurrence
(models/nif.nif_encode); the trainer uses direct trig
(models/nif.fourier_features).  This script measures what the encode
alone costs on the on-class 2048x4096 env: same weights, same eval
lattice, all-f32 chain, only the encode differs.

Usage: python scripts/encode_ab.py [--grid 2048x4096] [--max-batch 131072]
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

from ipu_path_trace_tpu.models.nif import (  # noqa: E402
    fourier_features,
    load_nif_assets,
)
from ipu_path_trace_tpu.models.synth_env import resolve_synth  # noqa: E402
from ipu_path_trace_tpu.models.nif import nif_encode  # noqa: E402
from ipu_path_trace_tpu.models.reconstruct import psnr_log  # noqa: E402

SYNTH = "synth:urban-alley:2048x4096:seed7"


def _old_recurrence(u, v, embedding_dim):
    """The pre-r5 kernel encode: pure double-angle recurrence seeded
    once at octave 0 (drifts ~2^j ulps; kept here for the record)."""
    uu = 2.0 * (u - 1.0)
    vv = 2.0 * (v - 1.0)
    su, cu = jnp.sin(uu), jnp.cos(uu)
    sv, cv = jnp.sin(vv), jnp.cos(vv)
    sus, cus, svs, cvs = [su], [cu], [sv], [cv]
    for _ in range(embedding_dim - 1):
        s, c = sus[-1], cus[-1]
        sus.append(2.0 * s * c)
        cus.append(1.0 - 2.0 * s * s)
        s, c = svs[-1], cvs[-1]
        svs.append(2.0 * s * c)
        cvs.append(1.0 - 2.0 * s * s)
    return jnp.stack(sus + svs + cus + cvs, axis=0)


def chain_f32(weights, feats):
    """Plain f32 MLP forward over (P, 4E) features (trainer layout)."""
    x = feats
    nl = len(weights.layers)
    for i, l in enumerate(weights.layers):
        w = jnp.asarray(l.kernel, jnp.float32)
        if x.shape[-1] != w.shape[0]:
            x = jnp.concatenate([x, feats], axis=-1)
        x = x @ w
        if l.bias is not None:
            x = x + jnp.asarray(l.bias, jnp.float32)
        if i < nl - 1:
            x = jnp.maximum(x, 0.0)
    return x


def reconstruct(weights, meta, h, w, max_batch, encode):
    rows, cols = np.meshgrid(np.arange(h, dtype=np.float32),
                             np.arange(w, dtype=np.float32), indexing="ij")
    u, v = (rows / h).ravel(), (cols / w).ravel()

    E = meta.embedding_dimension

    @jax.jit
    def fn(u, v):
        if encode == "direct":
            feats = fourier_features(u, v, E)
        elif encode == "kernel":  # the shipped kernel encode
            feats = nif_encode(u, v, E, jnp.float32).T
        else:  # the pre-r5 pure double-angle recurrence, for the record
            feats = _old_recurrence(u, v, E).T
        y = chain_f32(weights, feats)
        y = y * meta.max + jnp.asarray(meta.mean, jnp.float32)
        return jnp.exp(y) if meta.log_tone_map else y

    out = np.empty((h * w, 3), np.float32)
    t0 = time.monotonic()
    for lo in range(0, h * w, max_batch):
        sl = slice(lo, min(lo + max_batch, h * w))
        out[sl] = np.asarray(fn(jnp.asarray(u[sl]), jnp.asarray(v[sl])))
        if lo % (max_batch * 16) == 0:
            print(f"  batch {lo//max_batch} t={time.monotonic()-t0:.0f}s",
                  file=sys.stderr, flush=True)
    return out.reshape(h, w, 3)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--assets", default=os.path.join(
        REPO, "assets", "urban_alley_synth_nif"))
    ap.add_argument("--grid", default="2048x4096")
    ap.add_argument("--max-batch", type=int, default=131072)
    args = ap.parse_args()

    src = resolve_synth(SYNTH)
    h, w = (int(x) for x in args.grid.split("x"))
    stride = src.shape[0] // h
    src_eval = src[::stride, ::stride]

    _, meta, weights = load_nif_assets(args.assets)

    out = {"eval_grid": args.grid}
    for encode in ("direct", "kernel", "old_recurrence"):
        t0 = time.monotonic()
        rec = reconstruct(weights, meta, h, w, args.max_batch, encode)
        p = psnr_log(rec, src_eval)
        out[encode + "_psnr_db"] = round(p, 2)
        print(f"{encode:10s} {p:6.2f} dB ({time.monotonic()-t0:.0f}s)",
              file=sys.stderr)
    # Feature-level drift at the top octave, for the docs:
    uu = jnp.asarray(np.linspace(0, 1, 4096, dtype=np.float32))
    vv = jnp.zeros_like(uu)
    f_dir = np.asarray(fourier_features(uu, vv, meta.embedding_dimension))
    f_rec = np.asarray(nif_encode(uu, vv, meta.embedding_dimension,
                                  jnp.float32)).T
    out["feat_absdiff_max"] = float(np.abs(f_dir - f_rec).max())
    print(json.dumps(out))


if __name__ == "__main__":
    main()
