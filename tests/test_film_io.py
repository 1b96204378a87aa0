"""Film accumulation, tone mapping, PNG/EXR io, NIF loaders."""

import numpy as np
import jax.numpy as jnp
import pytest

from ipu_path_trace_tpu.core.records import TRACE_RECORD_DTYPE
from ipu_path_trace_tpu.film import Film, read_exr, save_images, tone_map, write_exr
from ipu_path_trace_tpu.models.nif import (
    NifMetaData,
    NifWeights,
    analyse_nif,
    load_nif_assets,
    make_params,
    make_synthetic_nif,
    nif_apply,
)


def test_film_accumulate_and_tonemap():
    film = Film(4, 2)
    recs = np.zeros(8, TRACE_RECORD_DTYPE)
    recs["u"] = np.arange(8) % 4
    recs["v"] = np.arange(8) // 4
    recs["r"] = 8.0
    recs["sampleCount"] = 4
    film.accumulate(recs)
    assert np.allclose(film.hdr[..., 0], 2.0)  # 8 / 4 samples
    # Second step accumulates; hdr_at_step divides by steps:
    film.accumulate(recs)
    assert np.allclose(film.hdr_at_step(2)[..., 0], 2.0)
    # Tone map: (2 * 2^0)^(1/2.2) * 255:
    ldr = film.ldr(2, exposure=0.0, gamma=2.2)
    expected = min(255, int(round((2.0 ** (1 / 2.2)) * 255)))
    assert abs(int(ldr[0, 0, 0]) - expected) <= 1
    assert ldr[0, 0, 1] == 0


def test_tonemap_matches_reference_math():
    hdr = np.asarray([[[0.5, 1.0, 4.0]]], np.float32)
    ldr = tone_map(hdr, step=1, exposure=1.0, gamma=2.0)
    # (x * 2^1)^(1/2) * 255, clamped:
    expect = np.clip(np.sqrt(hdr[0, 0] * 2.0) * 255.0, 0, 255).astype(np.uint8)
    assert np.abs(ldr[0, 0].astype(int) - expect.astype(int)).max() <= 1


def test_exr_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    img = (rng.random((17, 23, 3)) * 100.0).astype(np.float32)
    p = str(tmp_path / "t.exr")
    write_exr(p, img)
    assert np.array_equal(read_exr(p), img)
    # Half precision:
    write_exr(p, img, half=True)
    assert np.allclose(read_exr(p), img, rtol=1e-3, atol=0.1)


def test_save_images(tmp_path):
    hdr = np.ones((8, 8, 3), np.float32)
    ldr = np.full((8, 8, 3), 128, np.uint8)
    out = str(tmp_path / "render.png")
    save_images(out, hdr, ldr)
    assert (tmp_path / "render.png").exists()
    assert (tmp_path / "render.exr").exists()  # AccumulatedImage.cpp:11-14
    from ipu_path_trace_tpu.film.imageio import read_png

    assert read_png(out)[0, 0, 0] == 128


def test_save_images_exr_outfile(tmp_path):
    """-o render.exr must put the HDR at that exact path with the
    tone-mapped PNG alongside."""
    from ipu_path_trace_tpu.film.imageio import read_exr

    hdr = np.full((8, 8, 3), 2.5, np.float32)
    ldr = np.full((8, 8, 3), 10, np.uint8)
    save_images(str(tmp_path / "render.exr"), hdr, ldr)
    assert (tmp_path / "render.png").exists()
    np.testing.assert_array_equal(read_exr(str(tmp_path / "render.exr")), hdr)


@pytest.mark.parametrize("shape", [(1, 1), (5, 7), (48, 64)])
def test_png_roundtrip(tmp_path, shape):
    """The standard-library PNG writer and reader are inverses."""
    from ipu_path_trace_tpu.film.imageio import read_png, write_png

    rng = np.random.default_rng(shape[0])
    img = rng.integers(0, 256, shape + (3,), dtype=np.uint8)
    p = str(tmp_path / "rt.png")
    write_png(p, img)
    np.testing.assert_array_equal(read_png(p), img)


def test_png_decodes_with_pil(tmp_path):
    """Other decoders read the written PNG (PIL is only a test tool)."""
    from PIL import Image

    from ipu_path_trace_tpu.film.imageio import write_png

    img = np.arange(4 * 6 * 3, dtype=np.uint8).reshape(4, 6, 3) * 3
    p = str(tmp_path / "pil.png")
    write_png(p, img)
    np.testing.assert_array_equal(np.asarray(Image.open(p).convert("RGB")), img)


def test_png_reader_rejects_corruption(tmp_path):
    from ipu_path_trace_tpu.film.imageio import read_png, write_png

    p = tmp_path / "bad.png"
    write_png(str(p), np.zeros((2, 2, 3), np.uint8))
    blob = bytearray(p.read_bytes())
    blob[20] ^= 0xFF  # inside the IHDR payload -> CRC mismatch
    p.write_bytes(bytes(blob))
    with pytest.raises(ValueError, match="CRC"):
        read_png(str(p))
    with pytest.raises(ValueError, match="not a PNG"):
        (tmp_path / "x.png").write_bytes(b"nope")
        read_png(str(tmp_path / "x.png"))


def test_load_hdr_image_scaling_rule(tmp_path):
    """Integer files are 0..255-encoded; float files are radiance and
    must NOT be divided (one rule for --assets texture and the trainer)."""
    from ipu_path_trace_tpu.film.imageio import load_hdr_image, write_exr

    exr = str(tmp_path / "a.exr")
    write_exr(exr, np.full((4, 4, 3), 7.5, np.float32))
    assert load_hdr_image(exr).max() == 7.5
    from PIL import Image

    png = str(tmp_path / "a.png")
    Image.fromarray(np.full((4, 4, 3), 255, np.uint8)).save(png)
    np.testing.assert_allclose(load_hdr_image(png).max(), 1.0)


def test_nif_h5_roundtrip(tmp_path):
    weights, meta = make_synthetic_nif(key=1, hidden=32, num_hidden=2, embedding_dim=4)
    h5 = str(tmp_path / "converted.hdf5")
    weights.save_h5(h5)
    loaded = NifWeights.load_h5(h5)
    assert len(loaded.layers) == len(weights.layers)
    for a, b in zip(loaded.layers, weights.layers):
        assert a.kernel.shape == b.kernel.shape
        assert np.allclose(a.kernel, b.kernel, atol=1e-3)  # fp16 storage
        assert a.activation == b.activation

    meta_path = str(tmp_path / "nif_metadata.txt")
    meta.save(meta_path)
    loaded_meta = NifMetaData.load(meta_path)
    assert loaded_meta.embedding_dimension == meta.embedding_dimension
    assert loaded_meta.log_tone_map == meta.log_tone_map
    assert np.allclose(loaded_meta.mean, meta.mean, atol=1e-6)
    assert loaded_meta.hidden_size == 32

    # Full assets-dir load path (loadNifModels parity):
    params, meta2, w2 = load_nif_assets(str(tmp_path))
    out = nif_apply(params, jnp.asarray([0.5, 0.1]), jnp.asarray([0.25, 0.9]))
    assert out.shape == (2, 3)
    assert np.isfinite(np.asarray(out, np.float32)).all()


def test_reference_metadata_parses():
    """The shipped reference metadata file must parse with eps folding."""
    import os

    import pytest

    ref = ("/root/reference/nif_models/urban_alley_01_4k_fp16_yuv/"
           "assets.extra/nif_metadata.txt")
    if not os.path.exists(ref):
        pytest.skip("reference checkout not present")
    meta = NifMetaData.load(ref)
    assert meta.embedding_dimension == 12
    assert meta.hidden_size == 320
    assert meta.log_tone_map
    assert meta.image_shape == (2048, 4096, 3)
    # eps folded into mean (NifMetaData.cpp:49-53):
    assert abs(meta.mean[0] - (-2.3514461517333984 - 1e-8)) < 1e-9


def test_analyse_nif_flops():
    weights, _ = make_synthetic_nif(key=0, hidden=320, num_hidden=6, embedding_dim=12, skip_layer=None)
    info = analyse_nif(weights, 1)
    # 48->320, 5x 320->320, 320->3 (+biases):
    expect = (2 * 48 * 320 + 320) + 5 * (2 * 320 * 320 + 320) + (2 * 320 * 3 + 3)
    assert info["flops"] == expect


def test_skip_concat_detection():
    weights, meta = make_synthetic_nif(key=2, hidden=32, num_hidden=3, embedding_dim=4, skip_layer=1)
    params = make_params(weights, meta, jnp.float32)
    assert params.kernels[1].shape[0] == 32 + 16  # concat width
    out = nif_apply(params, jnp.asarray([0.3]), jnp.asarray([0.7]))
    assert out.shape == (1, 3)


def test_nif_loader_rejects_unknown_layers(tmp_path):
    import h5py, json

    p = str(tmp_path / "bad.h5")
    with h5py.File(p, "w") as f:
        f.attrs["model_config"] = json.dumps(
            {"class_name": "Functional",
             "config": {"layers": [{"class_name": "Conv2D", "config": {"name": "c"}}]}}
        )
    with pytest.raises(ValueError, match="Conv2D"):
        NifWeights.load_h5(p)


def test_film_skips_padding_and_zero_sample_records():
    """Padding records (DUMMY_COORD) and zero-sample records must not
    contribute to (or crash) accumulation - on both the NumPy and the
    native C++ path (csrc/pt_host.cpp skips coords outside the image)."""
    from ipu_path_trace_tpu.core.records import DUMMY_COORD, TRACE_RECORD_DTYPE
    from ipu_path_trace_tpu.film.film import Film

    recs = np.zeros(6, TRACE_RECORD_DTYPE)
    recs["u"] = [0, 1, DUMMY_COORD, 2, 3, DUMMY_COORD]
    recs["v"] = [0, 0, DUMMY_COORD, 0, 0, 1]
    recs["r"] = [2.0, 4.0, 99.0, 6.0, 8.0, 99.0]
    recs["sampleCount"] = [2, 2, 2, 2, 0, 2]  # record 4 has zero samples
    film = Film(4, 2)
    film.accumulate(recs)
    hdr = film.hdr_at_step(1)
    assert hdr[0, 0, 0] == pytest.approx(1.0)  # 2.0 / 2
    assert hdr[0, 1, 0] == pytest.approx(2.0)
    assert hdr[0, 2, 0] == pytest.approx(3.0)
    assert hdr[0, 3, 0] == 0.0  # zero-sample record contributes nothing
    assert np.isfinite(hdr).all()
    assert float(hdr.sum()) == pytest.approx(6.0)  # padding never lands


def test_film_native_and_numpy_paths_agree():
    """Force the NumPy fallback and compare against the default
    (native-if-built) accumulate + tonemap."""
    from ipu_path_trace_tpu.core.records import TRACE_RECORD_DTYPE
    from ipu_path_trace_tpu.film.film import Film
    from ipu_path_trace_tpu.runtime import native

    rng = np.random.default_rng(0)
    n = 512
    recs = np.zeros(n, TRACE_RECORD_DTYPE)
    recs["u"] = rng.permutation(n) % 32
    recs["v"] = np.arange(n) // 32
    for c in "rgb":
        recs[c] = rng.uniform(0, 20, n).astype(np.float32)
    recs["sampleCount"] = rng.integers(1, 9, n).astype(np.uint16)

    film_a = Film(32, 16)
    film_a.accumulate(recs)
    ldr_a = film_a.ldr(1, exposure=0.5, gamma=2.2)

    had = native._lib
    native._lib = None  # force the NumPy fallback
    try:
        film_b = Film(32, 16)
        film_b.accumulate(recs)
        ldr_b = film_b.ldr(1, exposure=0.5, gamma=2.2)
    finally:
        native._lib = had

    np.testing.assert_allclose(film_a.hdr, film_b.hdr, rtol=1e-6)
    # LDR may differ by 1 where pow() rounding straddles a .5 boundary:
    assert np.abs(ldr_a.astype(int) - ldr_b.astype(int)).max() <= 1
