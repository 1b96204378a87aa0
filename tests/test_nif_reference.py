"""The NIF chain against its plain float32 NumPy reference, for every
shipped asset, and the asset weight formats against each other.

The reference is cpu/oracle.nif_forward, which shares no code with
models/nif.nif_apply.  float32 params are compared at "highest" matmul
precision (an accelerator may otherwise run float32 products in TF32);
the production bf16 params carry bf16 activations through an exp
decode, so they get a statistical bound instead.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from ipu_path_trace_tpu.cpu import nif_forward
from ipu_path_trace_tpu.models.nif import (
    NifWeights,
    fourier_features,
    load_nif_assets,
    make_params,
    nif_apply,
    nif_encode,
)

ASSETS_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "assets")
ASSETS = sorted(d for d in os.listdir(ASSETS_DIR)
                if os.path.exists(os.path.join(ASSETS_DIR, d, "nif_metadata.txt")))


def test_every_asset_is_listed():
    assert len(ASSETS) == 8, ASSETS


def _lattice(n=64):
    g = ((np.arange(n) + 0.5) / n).astype(np.float32)
    u, v = np.meshgrid(g, g, indexing="ij")
    return u.ravel(), v.ravel()


@pytest.mark.parametrize("asset", ASSETS)
def test_nif_apply_matches_numpy_f32(asset):
    _, meta, weights = load_nif_assets(os.path.join(ASSETS_DIR, asset))
    params = make_params(weights, meta, jnp.float32)
    u, v = _lattice()
    ref = nif_forward(weights, meta, u, v)
    with jax.default_matmul_precision("highest"):
        out = np.asarray(jax.jit(nif_apply)(params, jnp.asarray(u),
                                            jnp.asarray(v)))
    assert out.shape == ref.shape == (u.size, 3)
    np.testing.assert_allclose(out, ref, rtol=1e-4)


@pytest.mark.parametrize("asset", ASSETS)
def test_nif_apply_bf16_within_bound(asset):
    """Production bf16 params: median relative error <= 2.5e-2 and 99th
    percentile <= 1.5e-1 (chip_smoke.py phase 3 holds the card to the
    same bounds)."""
    params, meta, weights = load_nif_assets(os.path.join(ASSETS_DIR, asset),
                                            jnp.bfloat16)
    u, v = _lattice()
    ref = nif_forward(weights, meta, u, v)
    out = np.asarray(jax.jit(nif_apply)(params, jnp.asarray(u), jnp.asarray(v)))
    rel = np.abs(out - ref) / np.abs(ref)
    assert np.median(rel) <= 2.5e-2
    assert np.quantile(rel, 0.99) <= 1.5e-1


@pytest.mark.parametrize("asset", ASSETS)
def test_npz_weights_equal_hdf5(asset):
    """converted.npz (what the loader reads) holds exactly the weights
    of converted.hdf5 (the interchange format)."""
    pytest.importorskip("h5py")
    d = os.path.join(ASSETS_DIR, asset)
    a = NifWeights.load_npz(os.path.join(d, "converted.npz"))
    b = NifWeights.load_h5(os.path.join(d, "converted.hdf5"))
    assert len(a.layers) == len(b.layers)
    for la, lb in zip(a.layers, b.layers):
        assert (la.name, la.activation, la.dtype) == (lb.name, lb.activation, lb.dtype)
        assert la.kernel.dtype == lb.kernel.dtype
        np.testing.assert_array_equal(la.kernel, lb.kernel)
        np.testing.assert_array_equal(la.bias, lb.bias)


@pytest.mark.parametrize("embedding_dim", [6, 12, 16])
def test_nif_encode_matches_fourier_features(embedding_dim):
    """The int8 chain's double-angle encode equals the direct encode to
    the recurrence's bounded drift."""
    u, v = _lattice(32)
    direct = np.asarray(fourier_features(jnp.asarray(u), jnp.asarray(v),
                                         embedding_dim))
    enc = np.asarray(nif_encode(jnp.asarray(u), jnp.asarray(v),
                                embedding_dim, jnp.float32)).T
    np.testing.assert_allclose(enc, direct, atol=2e-5)


def test_loader_without_npz_reads_hdf5(tmp_path):
    """A reference asset directory (no .npz) still loads, through HDF5."""
    pytest.importorskip("h5py")
    import shutil

    src = os.path.join(ASSETS_DIR, "nif_w128")
    for f in ("converted.hdf5", "nif_metadata.txt"):
        shutil.copy(os.path.join(src, f), tmp_path / f)
    p_h5, _, _ = load_nif_assets(str(tmp_path), jnp.float32)
    p_npz, _, _ = load_nif_assets(src, jnp.float32)
    for a, b in zip(p_h5.kernels, p_npz.kernels):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
