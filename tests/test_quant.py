"""int8 NIF quantization: PTQ correctness, padding exactness and the
integer chain against plain NumPy.

The quant scheme (models/quant.py) is symmetric per-output-channel int8
weights, constant-scale features, lattice-calibrated activation scales.
Three layers of evidence:

* the integer chain on zero-padded operands is BITWISE the unpadded
  chain given the same int8 features - zero padding never changes an
  integer accumulator;
* given the same int8 features, the jnp chain equals an integer NumPy
  evaluation of the same scheme;
* the quantised net tracks the f32 net to calibration accuracy (the
  real quality gate is trained on-class PSNR).

Reference analog: the fp16-weights / half-partials precision-for-speed
discipline of PathTracerApp.cpp:140-145,821-822, taken one step further.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from ipu_path_trace_tpu.models.nif import (
    make_params,
    make_synthetic_nif,
    nif_apply,
    nif_encode,
)
from ipu_path_trace_tpu.models.quant import (
    QMAX,
    ZP,
    nif_apply_quant,
    quant_layer_t,
    quant_mlp_t,
    quantize_nif,
)


def _uv(n, seed=3):
    rng = np.random.default_rng(seed)
    return (jnp.asarray(rng.uniform(0, 1, n), jnp.float32),
            jnp.asarray(rng.uniform(0, 1, n), jnp.float32))


@pytest.fixture(scope="module")
def small_nif():
    weights, meta = make_synthetic_nif(key=7, hidden=64, num_hidden=4,
                                       skip_layer=2)
    meta.log_tone_map = True
    return weights, meta


@pytest.fixture(scope="module")
def small_quant(small_nif):
    weights, meta = small_nif
    return quantize_nif(weights, meta, grid=(64, 128))


@pytest.mark.quick
def test_quantize_shapes_and_scales(small_nif, small_quant):
    weights, meta = small_nif
    qp = small_quant
    assert qp.skip_layer == 2
    assert qp.embedding_dim == meta.embedding_dimension
    for i, l in enumerate(weights.layers):
        assert qp.kernels[i].shape == l.kernel.shape
        assert qp.kernels[i].dtype == jnp.int8
        assert qp.mults[i].shape == (l.kernel.shape[1],)
    # Per-channel weight quantisation: every output channel uses the
    # full int8 range (absmax maps to +-127).
    for q in qp.kernels:
        assert int(jnp.abs(q).max(axis=0).min()) == 127
    # Requant steps: positive for hidden layers, sentinel 1 for the head.
    inv = np.asarray(qp.inv_next)
    assert (inv[:-1] > 0).all() and inv[-1] == 1.0
    # Skip-dot multiplier uses the constant feature scale 1/127.
    sw_skip = np.abs(np.asarray(weights.layers[2].kernel)).max(axis=0) / 127.0
    np.testing.assert_allclose(np.asarray(qp.mult_skip),
                               sw_skip / 127.0, rtol=1e-6)


def _pad_rows(x, rows):
    """Zero-pad the leading (feature) dim of x to ``rows``."""
    return jnp.pad(x, ((0, rows - x.shape[0]),) + ((0, 0),) * (x.ndim - 1))


def _int8_feats(qp, u, v):
    f = nif_encode(u, v, qp.embedding_dim, jnp.float32)
    return jnp.clip(jnp.round(f * QMAX), -QMAX, QMAX).astype(jnp.int8)


@pytest.mark.quick
def test_packed_chain_bitwise_vs_twin(small_quant):
    """Zero padding every contraction dim (and the head's output rows)
    must not change a single integer accumulator: the padded chain ==
    the unpadded twin, bitwise, when both consume the same int8
    features."""
    qp = small_quant
    u, v = _uv(777)  # not a multiple of anything
    twin = quant_mlp_t(qp, u, v)  # (3, P) pre-decode

    feats = _int8_feats(qp, u, v)  # (48, P)
    fpad = _pad_rows(feats, 64)
    pad_cols = lambda a, n: jnp.pad(a, ((0, 0), (0, n - a.shape[1])))
    skip, nl = qp.skip_layer, len(qp.kernels)
    x = fpad
    for i in range(nl):
        w_t = qp.kernels[i].T  # (out, in)
        out_p = 8 if i == nl - 1 else w_t.shape[0] + 16
        if i == skip:
            trunk = w_t.shape[1] - feats.shape[0]
            w_t = jnp.concatenate([pad_cols(w_t[:, :trunk], x.shape[0]),
                                   pad_cols(w_t[:, trunk:], fpad.shape[0])], 1)
        else:
            w_t = pad_cols(w_t, x.shape[0])
        w_t = _pad_rows(w_t, out_p)
        col = lambda a: _pad_rows(a, out_p)[:, None]
        mskip = col(qp.mult_skip) if i == skip else jnp.zeros((out_p, 1))
        x = quant_layer_t(x, fpad, w_t, col(qp.biases[i]), col(qp.mults[i]),
                          mskip, qp.inv_next[i],
                          is_last=i == nl - 1, is_skip=i == skip)
    assert x.shape[0] == 8
    assert jnp.array_equal(x[:3], twin)
    # Padded head rows are exactly zero (zero weights, zero bias):
    assert not np.asarray(x[3:]).any()


def _numpy_int_chain(qp, feats):
    """The int8 scheme in plain NumPy: int64 integer dots, float32
    per-element scaling in the order quant_layer_t uses."""
    f = np.asarray(feats).astype(np.int64)  # (4E, P)
    x = f
    nl, skip = len(qp.kernels), qp.skip_layer
    for i in range(nl):
        w_t = np.asarray(qp.kernels[i]).T.astype(np.int64)
        mult = np.asarray(qp.mults[i], np.float32)[:, None]
        bias = np.asarray(qp.biases[i], np.float32)[:, None]
        if i == skip:
            trunk = w_t.shape[1] - f.shape[0]
            acc = (w_t[:, :trunk] @ x).astype(np.float32)
            accf = (w_t[:, trunk:] @ f).astype(np.float32)
            y = (acc * mult + accf * np.asarray(qp.mult_skip, np.float32)[:, None]
                 + bias)
        else:
            y = (w_t @ x).astype(np.float32) * mult + bias
        if i == nl - 1:
            return y
        y = np.maximum(y, np.float32(0.0))
        q = np.round(y * np.float32(np.asarray(qp.inv_next)[i])) - np.float32(ZP)
        x = np.clip(q, -128, 127).astype(np.int64)


@pytest.mark.parametrize("arch", [
    dict(key=7, hidden=64, num_hidden=4, skip_layer=2),
    dict(key=3, hidden=48, num_hidden=3, skip_layer=None),
    dict(key=5, hidden=96, num_hidden=2, skip_layer=1, embedding_dim=6),
])
def test_int8_chain_matches_integer_numpy(arch):
    """Given the same int8 features, the jnp int8 chain (quant_layer_t)
    equals a plain integer NumPy evaluation of the scheme: every
    accumulator is an exact integer, so the only slack is f32 rounding
    of the scale multiply - far below one requant step, so the hidden
    integers agree and the head agrees to f32 rounding."""
    weights, meta = make_synthetic_nif(**arch)
    qp = quantize_nif(weights, meta, grid=(32, 64))
    u, v = _uv(600, seed=4)
    feats = _int8_feats(qp, u, v)
    nl, skip = len(qp.kernels), qp.skip_layer
    x = feats
    for i in range(nl):
        x = quant_layer_t(x, feats, qp.kernels[i].T, qp.biases[i][:, None],
                          qp.mults[i][:, None], qp.mult_skip[:, None],
                          qp.inv_next[i], is_last=i == nl - 1,
                          is_skip=i == skip)
    ref = _numpy_int_chain(qp, feats)
    np.testing.assert_allclose(np.asarray(x), ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())


@pytest.mark.quick
def test_quant_tracks_f32(small_nif, small_quant):
    """The int8 net approximates the f32 net to calibration accuracy.
    (The shipped quality gate is on-class PSNR at reference scale,
    scripts/quant_psnr.py.)"""
    weights, meta = small_nif
    params = make_params(weights, meta, jnp.float32)
    u, v = _uv(2000, seed=9)
    ref = np.asarray(nif_apply(params, u, v))
    out = np.asarray(nif_apply_quant(small_quant, u, v))
    scale = np.abs(ref).max()
    rel = np.abs(out - ref) / (np.abs(ref) + 1e-2 * scale)
    assert np.median(rel) < 3e-2
    # Random He-init nets + log decode amplify the int8 noise far more
    # than trained NIFs do (those are gated on PSNR); loose max bound.
    assert rel.max() < 0.35


@pytest.mark.quick
def test_fake_quant_matches_int_chain(small_nif):
    """The QAT fake-quant forward (models/quant.fake_quant_apply) must
    BE the inference quantiser: evaluated (no gradient) with the same
    activation grids, it matches the integer chain to f32-rounding of
    the factored-out scales (the integer sums themselves are exact in
    f32 below 2^24)."""
    from ipu_path_trace_tpu.models.nif import fourier_features
    from ipu_path_trace_tpu.models.quant import fake_quant_apply

    weights, meta = small_nif
    amax = None
    from ipu_path_trace_tpu.models.quant import (
        _f32_chain_activations,
        calibration_features,
    )
    amax = tuple(_f32_chain_activations(
        weights, calibration_features(meta.embedding_dimension, (64, 128))))
    qp = quantize_nif(weights, meta, amax=amax)

    u, v = _uv(600, seed=21)
    params = [
        (jnp.asarray(l.kernel, jnp.float32),
         jnp.asarray(l.bias, jnp.float32))
        for l in weights.layers
    ]
    feats = fourier_features(u, v, meta.embedding_dimension)
    fq = np.asarray(fake_quant_apply(params, feats, 2, amax))  # (P, 3)
    twin = np.asarray(quant_mlp_t(qp, u, v)).T  # pre-decode (P, 3)
    # fourier_features (direct sin) vs the int8 chain's double-angle encode
    # differ by up to ~0.005 - below one int8 step (1/127) but enough to
    # flip the round() on a sliver of features.  On rows where the two
    # encodes quantise identically the chains agree to f32 rounding of
    # the factored-out scales; overall the flips stay rare.
    f_kern = np.asarray(
        nif_encode(u, v, meta.embedding_dimension, jnp.float32)).T
    q_train = np.clip(np.round(np.asarray(feats) * 127), -127, 127)
    q_kern = np.clip(np.round(f_kern * 127), -127, 127)
    same = (q_train == q_kern).all(axis=1)
    assert same.mean() > 0.8
    # Even on grid-matched rows the two paths fold the scales in a
    # different order (fake-quant dequantises per element, inference
    # multiplies the integer accumulator once), so ulp-level input
    # differences can flip a requant tie mid-chain.  Bound the flip
    # FREQUENCY tightly on those rows and the median everywhere.
    rel_same = (np.abs(fq - twin) /
                (np.abs(twin) + 1e-2 * np.abs(twin).max()))[same]
    assert np.median(rel_same) < 1e-5
    assert (rel_same > 1e-2).mean() < 0.01
    rel = np.abs(fq - twin) / (np.abs(twin) + 1e-2 * np.abs(twin).max())
    assert np.median(rel) < 1e-3


def test_qat_finetune_smoke(small_nif):
    """A short QAT run returns same-shaped weights, finite loss, the
    calibration grids it trained against, and moves the weights."""
    from ipu_path_trace_tpu.models.quant import qat_finetune
    from ipu_path_trace_tpu.models.synth_env import resolve_synth

    weights, meta = small_nif
    img = resolve_synth("synth:urban-alley:64x128:seed3")
    new_w, amax, loss = qat_finetune(
        weights, meta, img, epochs=2, batch_size=2048,
        train_samples=4096, calib_grid=(32, 64), seed=5)
    assert np.isfinite(loss)
    assert len(amax) == len(weights.layers) - 1 and all(a > 0 for a in amax)
    for old, new in zip(weights.layers, new_w.layers):
        assert new.kernel.shape == old.kernel.shape
        assert not np.array_equal(new.kernel, old.kernel)
    # The fine-tuned net still quantises through the same pipeline.
    qp = quantize_nif(new_w, meta, amax=amax)
    u, v = _uv(128, seed=1)
    assert np.isfinite(np.asarray(nif_apply_quant(qp, u, v))).all()


@pytest.mark.quick
def test_app_nif_precision_int8(tmp_path):
    """--nif-precision int8 end-to-end: the app loads the asset into a
    QuantNifParams env (honouring a QAT quant_amax.json sidecar) and a
    step produces finite radiance."""
    import json as _json
    import os

    from ipu_path_trace_tpu.models.quant import QuantNifParams
    from ipu_path_trace_tpu.models.train_nif import save_assets
    from ipu_path_trace_tpu.runtime.app import PathTracerApp
    from ipu_path_trace_tpu.runtime.config import Config

    weights, meta = make_synthetic_nif(key=3, hidden=32, num_hidden=2,
                                       skip_layer=1)
    assets = str(tmp_path / "nif_assets")
    save_assets(assets, weights, meta, ["synthetic"])
    amax = [2.5, 1.25]
    with open(os.path.join(assets, "quant_amax.json"), "w") as f:
        _json.dump({"amax": amax, "calibration_grid": "32x64"}, f)

    cfg = Config(
        outfile=str(tmp_path / "int8.png"), assets=assets,
        width=32, height=16, samples=2, samples_per_step=2,
        save_interval=1, seed=5, max_path_length=3,
        nif_precision="int8",
    )
    cfg.validate()
    app = PathTracerApp(cfg)
    app.init()
    assert isinstance(app.env.params, QuantNifParams)
    # The sidecar grids, not a fresh calibration, set the requant steps
    # (asymmetric activation grid: 255/a, models/quant.py):
    np.testing.assert_allclose(
        np.asarray(app.env.params.inv_next)[:-1],
        [255.0 / a for a in amax], rtol=1e-6)
    app.build()
    app.execute()
    hdr = app.film.hdr_at_step(1)
    assert np.isfinite(hdr).all()
    assert (hdr >= 0).all()


@pytest.mark.quick
def test_cli_nif_precision_flag(tmp_path):
    """--nif-precision parses and lands in Config; bad values rejected."""
    from ipu_path_trace_tpu.runtime.cli import parse_config

    argv = ["--assets", "a", "--outfile", str(tmp_path / "o.png"),
            "--nif-precision", "int8"]
    cfg = parse_config(argv)
    assert cfg.nif_precision == "int8"
    cfg = parse_config(argv[:-2] + ["--nif-precision", "auto"])
    assert cfg.nif_precision == "auto"
    with pytest.raises(SystemExit):
        parse_config(argv[:-1] + ["fp4"])


def test_calibration_covers_domain(small_nif):
    """Activation scales from the UV lattice bound the activations seen
    on random UVs: requantisation never saturates more than the odd
    near-max lane (the input domain IS the lattice's domain)."""
    weights, meta = small_nif
    qp = quantize_nif(weights, meta, grid=(64, 128))
    u, v = _uv(4000, seed=17)
    x = quant_mlp_t(qp, u, v)
    assert np.isfinite(np.asarray(x)).all()
