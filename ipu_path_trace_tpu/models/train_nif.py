"""Train a Neural Image Field from an equirect HDR image - in JAX.

The reference consumes NIF models produced by an external keras trainer
(the `train_command` recorded in nif_metadata.txt; the repo itself ships
only the conversion script src/keras/model_to_hdf5.py).  This module
makes the framework self-sufficient: it trains the same architecture
(Fourier-feature MLP, fp16-class weights) with the same encode/decode
contract and writes a reference-compatible assets directory
(converted.hdf5 + nif_metadata.txt) that both this framework's loader
and the reference's Hdf5Model/NifMetaData parsers understand.

Encode contract (inverse of NifModel.cpp:221-245 decoding):
    z      = log(y + eps)            (log tone map; else z = y)
    mean_c = mean(z) per channel
    max    = max|z - mean|           (scalar)
    target = (z - mean) / max        in [-1, 1]
Channel order is **BGR** - the renderer flips the network output
(codelets.cpp:377-378), matching models trained from OpenCV-loaded
(BGR) images.

Run:  python -m ipu_path_trace_tpu.models.train_nif <image.exr> <out_dir>
          [--layer-size 320 | --layer-sizes 256,128,208,256,128,128]
          [--layer-count 6] [--embedding-dimension 12]
          [--epochs N] [--batch-size 16384] [--train-samples N]

--layer-sizes trains mixed-width nets (per-layer widths).
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Sequence

import numpy as np
import jax
import jax.numpy as jnp
import optax

from ..utils.logging import logger
from .nif import NifLayer, NifMetaData, NifWeights, fourier_features, save_weights


def encode_targets(image: np.ndarray, eps: float, log_tone_map: bool):
    """RGB float image -> (bgr targets, mean(3), max) per the NIF contract."""
    bgr = image[..., ::-1].astype(np.float64)
    z = np.log(bgr + eps) if log_tone_map else bgr
    mean = z.reshape(-1, 3).mean(axis=0)
    max_abs = float(np.abs(z - mean).max())
    targets = ((z - mean) / max_abs).astype(np.float32)
    return targets, mean.astype(np.float32), max_abs


def _init_params(key, dims):
    params = []
    for fan_in, fan_out in dims:
        key, k1, k2 = jax.random.split(key, 3)
        w = jax.random.normal(k1, (fan_in, fan_out)) * jnp.sqrt(2.0 / fan_in)
        b = jnp.zeros((fan_out,))
        params.append((w, b))
    return params


def _mlp_apply(params, feats, skip_layer):
    x = feats
    for i, (w, b) in enumerate(params):
        if skip_layer is not None and i == skip_layer:
            x = jnp.concatenate([x, feats], axis=-1)
        x = x @ w + b
        if i != len(params) - 1:
            x = jax.nn.relu(x)
    return x


def train_nif(
    image: np.ndarray,
    *,
    layer_size: int | Sequence[int] = 320,
    layer_count: int = 6,
    embedding_dim: int = 12,
    skip_layer: int | None = 3,
    epochs: int = 10,
    batch_size: int = 16384,
    train_samples: int | None = None,
    learning_rate: float = 1e-3,
    cosine_decay: bool = False,  # cosine-decay lr over the whole run
    eps: float = 1e-8,
    log_tone_map: bool = True,
    seed: int = 0,
    name: str = "trained",
) -> tuple[NifWeights, NifMetaData, float]:
    """Train and return (weights, metadata, final_loss).

    One "epoch" visits train_samples pixels (default: every pixel once).
    """
    h, w = image.shape[:2]
    targets, mean, max_abs = encode_targets(image, eps, log_tone_map)
    targets_flat = jnp.asarray(targets.reshape(-1, 3))

    rows, cols = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    uv = jnp.asarray(
        np.stack([rows.ravel() / h, cols.ravel() / w], axis=1).astype(np.float32)
    )
    n = uv.shape[0]
    train_samples = train_samples or n

    widths = ([layer_size] * layer_count if isinstance(layer_size, int)
              else list(layer_size))
    if len(widths) != layer_count:
        raise ValueError(f"need {layer_count} layer sizes, got {widths}")
    if skip_layer is not None and not (0 <= skip_layer < layer_count):
        # A skip index at/after the output layer would build weights the
        # forward pass never matches (shape error deep in jax); fail
        # with the actual constraint instead.
        raise ValueError(
            f"skip_layer={skip_layer} must be a hidden-layer index "
            f"(< layer_count={layer_count}) or None")
    in_dim = 4 * embedding_dim
    dims = []
    cur = in_dim
    for i in range(layer_count):
        fan_in = cur + in_dim if (skip_layer is not None and i == skip_layer) else cur
        dims.append((fan_in, widths[i]))
        cur = widths[i]
    dims.append((cur, 3))

    key = jax.random.key(seed)
    key, init_key = jax.random.split(key)
    params = _init_params(init_key, dims)
    steps_per_epoch_sched = max(1, train_samples // batch_size)
    if cosine_decay:
        # Cosine-decay to ~1% of the peak lr over the whole run: Adam at
        # a fixed lr plateaus well above the model's attainable loss.
        lr = optax.cosine_decay_schedule(
            learning_rate, epochs * steps_per_epoch_sched, alpha=0.01
        )
    else:
        lr = learning_rate
    tx = optax.adam(lr)
    opt_state = tx.init(params)

    def loss_fn(params, uv_batch, y_batch):
        feats = fourier_features(uv_batch[:, 0], uv_batch[:, 1], embedding_dim)
        pred = _mlp_apply(params, feats, skip_layer)
        return jnp.mean((pred - y_batch) ** 2)

    @jax.jit
    def train_step(params, opt_state, key):
        idx = jax.random.randint(key, (batch_size,), 0, n)
        loss, grads = jax.value_and_grad(loss_fn)(params, uv[idx], targets_flat[idx])
        updates, opt_state = tx.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, loss

    steps_per_epoch = max(1, train_samples // batch_size)
    loss = float("nan")
    t0 = time.monotonic()
    for epoch in range(epochs):
        for _ in range(steps_per_epoch):
            key, sk = jax.random.split(key)
            params, opt_state, loss = train_step(params, opt_state, sk)
        logger().info("epoch %d/%d loss %.5f", epoch + 1, epochs, float(loss))
    logger().info("Training finished in %.1fs", time.monotonic() - t0)

    layers = [
        NifLayer(
            name=f"dense_{i}",
            kernel=np.asarray(wgt, np.float32),
            bias=np.asarray(b, np.float32),
            activation="none" if i == len(params) - 1 else "relu",
            dtype="float16",
        )
        for i, (wgt, b) in enumerate(params)
    ]
    weights = NifWeights(layers)
    meta = NifMetaData(
        embedding_dimension=embedding_dim,
        name=name,
        image_shape=(h, w, 3),
        eps=eps,
        log_tone_map=log_tone_map,
        max=max_abs,
        mean=(mean - eps) if log_tone_map else mean,  # folded like the loader
        hidden_size=widths[0],
    )
    return weights, meta, float(loss)


def save_assets(out_dir: str, weights: NifWeights, meta: NifMetaData, train_command) -> None:
    os.makedirs(out_dir, exist_ok=True)
    save_weights(out_dir, weights)
    meta.save(os.path.join(out_dir, "nif_metadata.txt"), train_command)
    logger().info("Wrote NIF assets to %s", out_dir)


def build_parser() -> argparse.ArgumentParser:
    """The trainer CLI.  Exposed so tooling (and the shipped-asset
    replayability test) can validate recorded train_commands against
    the REAL parser rather than a hand-kept mirror."""
    p = argparse.ArgumentParser(prog="train_nif")
    p.add_argument("input", help="equirect HDR image (.exr) or LDR image")
    p.add_argument("out_dir", help="output assets directory")
    p.add_argument("--layer-size", type=int, default=320)
    p.add_argument("--layer-sizes", type=str, default=None,
                   help="comma-separated per-layer widths (overrides "
                        "--layer-size; mixed-width nets)")
    p.add_argument("--layer-count", type=int, default=6)
    p.add_argument("--embedding-dimension", type=int, default=12)
    p.add_argument("--skip-layer", type=int, default=3,
                   help="hidden-layer index of the input skip-concat "
                        "(canonical NIFs skip at 3); -1 disables it")
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--batch-size", type=int, default=16384)
    p.add_argument("--train-samples", type=int, default=None)
    p.add_argument("--learning-rate", type=float, default=1e-3)
    p.add_argument("--cosine-decay", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from ..film.imageio import load_hdr_image
    from .synth_env import resolve_synth

    # `synth:urban-alley:<H>x<W>:seed<N>` pseudo-paths resolve through
    # the deterministic generator (models/synth_env.py), so shipped
    # reference-scale assets replay without a 100 MB EXR in the repo.
    img = resolve_synth(args.input)
    if img is None:
        img = load_hdr_image(args.input)
    sizes: int | Sequence[int] = args.layer_size
    if args.layer_sizes:
        sizes = [int(t) for t in args.layer_sizes.split(",")]
        args.layer_count = len(sizes)
    weights, meta, loss = train_nif(
        img,
        layer_size=sizes,
        layer_count=args.layer_count,
        embedding_dim=args.embedding_dimension,
        skip_layer=None if args.skip_layer < 0 else args.skip_layer,
        epochs=args.epochs,
        batch_size=args.batch_size,
        train_samples=args.train_samples,
        learning_rate=args.learning_rate,
        cosine_decay=args.cosine_decay,
        seed=args.seed,
        name=os.path.abspath(args.input),
    )
    # Record a REPLAYABLE command (the same format nif_width_sweep.py
    # writes and tests/test_shipped_assets.py validates): it must parse
    # through build_parser() and include every knob that shaped the
    # weights, so re-running it reproduces this asset.  --layer-size
    # stays present for uniform widths - the reference scrapes it from
    # train_command (NifMetaData.cpp:56-64), as does models/nif.py.
    cmd = ["python", "-m", "ipu_path_trace_tpu.models.train_nif",
           args.input, args.out_dir,
           "--layer-count", str(args.layer_count)]
    if args.layer_sizes:
        cmd += ["--layer-sizes", args.layer_sizes]
    else:
        cmd += ["--layer-size", str(args.layer_size)]
    cmd += ["--embedding-dimension", str(args.embedding_dimension),
            "--skip-layer", str(args.skip_layer),
            "--epochs", str(args.epochs),
            "--batch-size", str(args.batch_size),
            "--learning-rate", str(args.learning_rate),
            "--seed", str(args.seed)]
    if args.train_samples is not None:
        cmd += ["--train-samples", str(args.train_samples)]
    if args.cosine_decay:
        cmd += ["--cosine-decay"]
    save_assets(args.out_dir, weights, meta, cmd)
    print(f"final loss: {loss:.6f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
