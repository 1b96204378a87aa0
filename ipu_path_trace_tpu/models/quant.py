"""Post-training int8 quantization of the NIF matmul chain.

The render step is dominated by the NIF matmul chain, and int8 tensor
arithmetic has twice the peak rate of bf16.  This module turns a loaded
NIF into an int8 form (--nif-precision int8) - the reference's
precision-for-speed discipline (fp16 weights + half partials,
PathTracerApp.cpp:140-145,821-822) taken one step further than its
hardware could.

Scheme (all symmetric, zero-point 0):

* **Weights**: per-output-channel scales sw[oc] = absmax(w[:, oc])/127.
  Per-channel roughly halves weight quantisation error vs per-tensor
  at no extra cost - the accumulator multiplier becomes an (out,)
  vector instead of a scalar, the same broadcast either way.
* **Fourier features**: exactly in [-1, 1], so their scale is the
  CONSTANT 1/127 - no calibration, and the skip-concat rows keep full
  precision relative to their range.
* **Hidden activations**: post-ReLU (>= 0), per-layer static grids
  from a calibration pass over a uniform UV lattice (the NIF's whole
  input domain - unlike generic nets its input distribution is KNOWN,
  so lattice calibration is exhaustive, not a sample).  The grid is
  ASYMMETRIC with a fixed zero point of -128: a ReLU output lives in
  [0, a_i], so a symmetric grid would waste the sign bit (7 effective
  bits); mapping [0, a_i] onto the full [-128, 127] doubles activation
  resolution (+6 dB on the activation-quantisation noise floor).  The
  zero point folds EXACTLY into the next layer's bias - for
  x ~= (q + 128) * s the dot contributes s*128*sum_i w[:, i], a
  per-output-channel constant - so the chain pays nothing: the only
  arithmetic change is the requant's -128 shift.
* **Skip layer**: runs as TWO dots (trunk columns x activation scale,
  feature columns x 1/127) so each operand keeps its own scale; the
  total contraction width is unchanged, so the matmul cost is identical.
* **Head**: int8 dot -> i32 -> f32 multiplier; the decode
  (y*max + mean, exp) stays f32 - the HDR range never touches int8.

The quantised forward is pure integer dots + per-element f32 ops, so
given the SAME int8 features every backend computes the same integers -
and zero padding never changes an integer accumulator
(tests/test_quant.py pins this).  Backends differ only through the f32
Fourier encode: the double-angle recurrence (models/nif.nif_encode)
doubles a 1-ulp FMA-contraction difference per octave (the doubling
map is chaotic), so features can land on opposite sides of the round()
tie on different backends.  Cross-backend parity is therefore
statistical (chip_smoke.py compares the card with the CPU).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from .nif import NifMetaData, NifWeights, nif_encode

QMAX = 127.0  # symmetric grid: weights and Fourier features
AQMAX = 255.0  # asymmetric activation grid: [0, a_i] -> [-128, 127]
ZP = 128.0  # activation zero point (folded into the next bias)


class QuantNifParams(NamedTuple):
    """Pytree of device arrays for int8 NIF inference.

    Layer i computes  acc = dot(int8 w_i, int8 x_i)  (i32), then
    y = acc * mults[i] + biases[i]  (f32), ReLU, and requantises with
    x_{i+1} = clip(round(y * inv_next[i]) - 128) onto the asymmetric
    [-128, 127] grid (the +128 zero point is pre-folded into
    biases[i+1], module docstring).  The skip layer adds
    accf * mult_skip for its feature columns.  Shapes are the REAL
    model shapes.
    """

    kernels: tuple  # int8 (in, out) per layer (feature cols last at skip)
    biases: tuple  # f32 (out,) per layer (zero-point fold included)
    mults: tuple  # f32 (out,) per layer: sw[oc] * (input scale)
    mult_skip: Any  # f32 (out,) skip layer's feature-dot multiplier
    inv_next: Any  # f32 (L,) requant steps 255/a_i (last entry unused, 1)
    max: Any  # () f32 decode scalars, as NifParams
    mean: Any  # (3,) f32
    log_tone_map: Any  # () bool_

    @property
    def embedding_dim(self) -> int:
        return self.kernels[0].shape[0] // 4

    @property
    def skip_layer(self) -> int:
        """Index of the skip-concat layer, re-detected from shapes like
        every other inference path (NifModel.cpp:303-309); -1 = none."""
        for i in range(1, len(self.kernels)):
            if self.kernels[i].shape[0] != self.kernels[i - 1].shape[1]:
                return i
        return -1


def _f32_chain_activations(weights: NifWeights, feats: np.ndarray,
                           chunk: int = 1 << 15):
    """f32 forward over (P, 4E) features; returns the per-hidden-layer
    post-ReLU output absmax (the activation calibration).  Jitted and
    chunked so a reference-scale calibration lattice runs on the
    attached device instead of in single-threaded NumPy."""
    params = [
        (jnp.asarray(l.kernel, jnp.float32),
         jnp.asarray(l.bias if l.bias is not None
                     else np.zeros(l.kernel.shape[1]), jnp.float32))
        for l in weights.layers
    ]

    @jax.jit
    def chunk_amax(f):
        x = f
        out = []
        for i, (w, b) in enumerate(params):
            if x.shape[-1] != w.shape[0]:
                x = jnp.concatenate([x, f], axis=-1)
            y = x @ w + b
            if i < len(params) - 1:
                y = jnp.maximum(y, 0.0)
                out.append(jnp.abs(y).max())
            x = y
        return jnp.stack(out)

    n = feats.shape[0]
    amax = np.zeros((len(params) - 1,), np.float64)
    for lo in range(0, n, chunk):
        f = jnp.asarray(feats[lo : lo + chunk], jnp.float32)
        amax = np.maximum(amax, np.asarray(chunk_amax(f), np.float64))
    return [max(1e-6, float(a)) for a in amax]


def calibration_features(embedding_dim: int, grid=(256, 512)) -> np.ndarray:
    """Fourier features over a uniform UV lattice covering the input
    domain, with the int8 chain's double-angle encode (nif_encode) so
    calibration sees the exact values inference will."""
    h, w = grid
    u = (np.arange(h, dtype=np.float32) + 0.5) / h
    v = (np.arange(w, dtype=np.float32) + 0.5) / w
    uu, vv = [g.reshape(-1) for g in np.meshgrid(u, v, indexing="ij")]
    feats = nif_encode(jnp.asarray(uu), jnp.asarray(vv), embedding_dim,
                       jnp.float32)  # (4E, P)
    return np.asarray(feats).T  # (P, 4E)


def quantize_nif(
    weights: NifWeights, meta: NifMetaData, grid=(256, 512), amax=None
) -> QuantNifParams:
    """PTQ a loaded NIF: per-channel int8 weights + lattice-calibrated
    activation scales (module docstring).  QAT'd nets pass the ``amax`` their fine-tune
    trained against (qat_finetune) so inference reuses those grids."""
    if amax is None:
        feats = calibration_features(meta.embedding_dimension, grid)
        amax = _f32_chain_activations(weights, feats)

    kernels, biases, mults = [], [], []
    mult_skip = None
    nl = len(weights.layers)
    inv_next = np.ones((nl,), np.float32)
    prev_w = weights.layers[0].kernel.shape[0]  # = 4E
    for i, l in enumerate(weights.layers):
        w = l.kernel.astype(np.float32)  # (in, out)
        sw = np.maximum(np.abs(w).max(axis=0), 1e-12) / QMAX  # (out,)
        q = np.clip(np.round(w / sw), -QMAX, QMAX).astype(np.int8)
        kernels.append(jnp.asarray(q))
        b = (l.bias if l.bias is not None
             else np.zeros(w.shape[1])).astype(np.float32)
        in_scale = (1.0 / QMAX) if i == 0 else amax[i - 1] / AQMAX
        mult = (sw * in_scale).astype(np.float32)
        mults.append(jnp.asarray(mult))
        if w.shape[0] != prev_w:  # skip-concat layer
            mult_skip = jnp.asarray(sw * (1.0 / QMAX), jnp.float32)
        if i > 0:
            # Zero-point fold: the asymmetric input dequantises as
            # (q + 128) * s, so the dot owes mult * 128 * colsum of the
            # int8 trunk rows (feature rows at the skip layer carry the
            # symmetric grid, zero point 0 - excluded).  Padded rows are
            # zero weights, so padding stays exact.
            trunk = prev_w  # rows fed by the hidden activation
            ksum = q[:trunk, :].astype(np.float32).sum(axis=0)
            b = b + mult * np.float32(ZP) * ksum
        biases.append(jnp.asarray(b))
        if i < nl - 1:
            inv_next[i] = AQMAX / amax[i]
        prev_w = w.shape[1]
    if mult_skip is None:
        mult_skip = jnp.zeros_like(mults[0])

    mean = meta.mean.copy()
    return QuantNifParams(
        kernels=tuple(kernels),
        biases=tuple(biases),
        mults=tuple(mults),
        mult_skip=mult_skip,
        inv_next=jnp.asarray(inv_next),
        max=jnp.float32(meta.max),
        mean=jnp.asarray(mean, jnp.float32),
        log_tone_map=jnp.asarray(meta.log_tone_map),
    )


def quant_layer_t(x, feats, w_t, bias_c, mult_c, mult_skip_c, inv_next,
                  is_last: bool, is_skip: bool):
    """One int8 Dense stage, feature-major ((in, B) activations, (out,
    in) weights).

    ``x`` int8 (in, B); ``feats`` int8 (4E, B) for the skip dot;
    weight/bias/multiplier refs are already sliced to this layer.
    Returns f32 (out, B) for the head, int8 for hidden layers.
    """
    dn = (((1,), (0,)), ((), ()))
    if is_skip:
        trunk = w_t.shape[1] - feats.shape[0]
        acc = jax.lax.dot_general(w_t[:, :trunk], x, dn,
                                  preferred_element_type=jnp.int32)
        accf = jax.lax.dot_general(w_t[:, trunk:], feats, dn,
                                   preferred_element_type=jnp.int32)
        y = (acc.astype(jnp.float32) * mult_c
             + accf.astype(jnp.float32) * mult_skip_c + bias_c)
    else:
        acc = jax.lax.dot_general(w_t, x, dn,
                                  preferred_element_type=jnp.int32)
        y = acc.astype(jnp.float32) * mult_c + bias_c
    if is_last:
        return y
    y = jnp.maximum(y, 0.0)
    # Asymmetric requant: [0, a_i] onto the full [-128, 127] (the +128
    # zero point is pre-folded into the NEXT layer's bias).
    return jnp.clip(jnp.round(y * inv_next) - ZP, -128.0, 127.0).astype(
        jnp.int8)


def quant_mlp_t(params: QuantNifParams, u, v):
    """Encode -> int8 chain -> f32 head output, feature-major.

    Uses the double-angle encode (nif_encode), the encode the
    activation calibration saw.  Returns (3, B) f32 in network channel
    order, BEFORE decode.
    """
    feats_f = nif_encode(u, v, params.embedding_dim, jnp.float32)
    feats = jnp.clip(jnp.round(feats_f * QMAX), -QMAX, QMAX).astype(jnp.int8)
    skip = params.skip_layer
    nl = len(params.kernels)
    x = feats
    for i in range(nl):
        x = quant_layer_t(
            x, feats, params.kernels[i].T,
            params.biases[i][:, None], params.mults[i][:, None],
            params.mult_skip[:, None], params.inv_next[i],
            is_last=i == nl - 1, is_skip=i == skip,
        )
    return x


def nif_apply_quant(params: QuantNifParams, u, v) -> jnp.ndarray:
    """Quantised drop-in for models.nif.nif_apply -> (P, 3) f32 decoded
    radiance in network channel order."""
    y = quant_mlp_t(params, u, v).T  # (P, 3)
    y = y * params.max + params.mean
    return jnp.where(params.log_tone_map, jnp.exp(y), y)


# ------------------------------------------------------------------------
# Quantisation-aware fine-tuning (QAT)
# ------------------------------------------------------------------------
#
# PTQ alone loses on-class quality: the pretrained weights were never
# asked to be robust to the int8 grids.  QAT re-fits them THROUGH the
# exact inference quantiser with straight-through-estimator gradients,
# so the optimiser absorbs the representable-grid error back into the
# fit.  Activation grids stay FIXED at the pretrained calibration - the
# same amax is then handed to quantize_nif, so training and inference
# quantise identically by construction.


def _ste(x, q):
    """Straight-through estimator: forward q(x), gradient of identity."""
    return x + jax.lax.stop_gradient(q - x)


def fake_quant_apply(params, feats, skip_layer, amax):
    """Training-layout forward ((B, in) batch-major like the trainer's
    _mlp_apply, train_nif.py:67-75) with every inference quantisation
    point fake-quantised under STE:

    * features snapped to the constant 1/127 grid,
    * weights per-output-channel symmetric int8 (scales recomputed from
      the LIVE weights each step, so the gradient shapes the scales),
    * post-ReLU activations on the fixed calibrated per-layer grids.

    ``params`` is a list of (w, b) jnp arrays; ``amax`` a static tuple
    of per-hidden-layer floats.  The head's output stays f32, exactly
    like inference (decode never touches int8).
    """
    feats = _ste(feats, jnp.round(jnp.clip(feats, -1, 1) * QMAX) / QMAX)
    x = feats
    nl = len(params)
    for i, (w, b) in enumerate(params):
        sw = jnp.maximum(jnp.abs(jax.lax.stop_gradient(w)).max(axis=0),
                         1e-12) / QMAX
        wq = _ste(w, jnp.clip(jnp.round(w / sw), -QMAX, QMAX) * sw)
        if skip_layer is not None and i == skip_layer:
            x = jnp.concatenate([x, feats], axis=-1)
        x = x @ wq + b
        if i != nl - 1:
            x = jax.nn.relu(x)
            # Same round form as inference (x * inv_next, models/quant
            # quant_layer_t): x/step rounds DIFFERENTLY at ties in f32.
            # Asymmetric grid: 256 levels over [0, a_i] (quant_layer_t's
            # requant minus its bias-folded zero point).
            inv = jnp.float32(AQMAX / amax[i])
            step = jnp.float32(amax[i] / AQMAX)
            x = _ste(x, jnp.clip(jnp.round(x * inv), 0, AQMAX) * step)
    return x


def qat_finetune(
    weights: NifWeights,
    meta: NifMetaData,
    image: np.ndarray,
    *,
    epochs: int = 2000,
    batch_size: int = 16384,
    train_samples: int | None = None,
    learning_rate: float = 2e-4,
    calib_grid=(256, 512),
    seed: int = 0,
):
    """Fine-tune a trained NIF through the int8 fake-quant forward.

    Same data pipeline and loss as the trainer (train_nif.train_nif),
    started from the trained weights with a cosine-decayed low lr.
    Returns (new NifWeights, amax tuple, final_loss); pass the SAME
    amax to quantize_nif so inference uses the grids training saw.
    """
    import optax

    from .nif import fourier_features
    from .train_nif import encode_targets

    amax = tuple(_f32_chain_activations(
        weights, calibration_features(meta.embedding_dimension, calib_grid)))

    h, w = image.shape[:2]
    targets, _, _ = encode_targets(image, meta.eps, meta.log_tone_map)
    targets_flat = jnp.asarray(targets.reshape(-1, 3))
    rows, cols = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    uv = jnp.asarray(np.stack(
        [rows.ravel() / h, cols.ravel() / w], axis=1).astype(np.float32))
    n = uv.shape[0]
    train_samples = train_samples or n

    skip = None
    prev = weights.layers[0].kernel.shape[0]
    for i, l in enumerate(weights.layers[1:], start=1):
        if l.kernel.shape[0] != prev:
            skip = i
        prev = l.kernel.shape[1]

    params = [
        (jnp.asarray(l.kernel, jnp.float32),
         jnp.asarray(l.bias if l.bias is not None
                     else np.zeros(l.kernel.shape[1]), jnp.float32))
        for l in weights.layers
    ]
    steps_per_epoch = max(1, train_samples // batch_size)
    lr = optax.cosine_decay_schedule(
        learning_rate, epochs * steps_per_epoch, alpha=0.01)
    tx = optax.adam(lr)
    opt_state = tx.init(params)

    def loss_fn(params, uv_batch, y_batch):
        feats = fourier_features(uv_batch[:, 0], uv_batch[:, 1],
                                 meta.embedding_dimension)
        pred = fake_quant_apply(params, feats, skip, amax)
        return jnp.mean((pred - y_batch) ** 2)

    @jax.jit
    def train_step(params, opt_state, key):
        idx = jax.random.randint(key, (batch_size,), 0, n)
        loss, grads = jax.value_and_grad(loss_fn)(
            params, uv[idx], targets_flat[idx])
        updates, opt_state = tx.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, loss

    key = jax.random.key(seed)
    loss = float("nan")
    for _ in range(epochs):
        for _ in range(steps_per_epoch):
            key, sk = jax.random.split(key)
            params, opt_state, loss = train_step(params, opt_state, sk)

    from .nif import NifLayer

    new_layers = [
        NifLayer(name=l.name, kernel=np.asarray(wgt, np.float32),
                 bias=np.asarray(b, np.float32), activation=l.activation,
                 dtype=l.dtype)
        for l, (wgt, b) in zip(weights.layers, params)
    ]
    return NifWeights(new_layers), amax, float(loss)
