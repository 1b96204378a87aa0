"""--debug-view: diagnostic save modes (film/debugview.py).

The reference's accumulator DEBUG case short-circuits stored colour into
the film (codelets.cpp:283-285) and PreProcessEscapedRays overwrites
c.clr with the equirect UVs for debugging (codelets.cpp:345); these
tests pin this port's analog - a save-path diagnostic channel - at
both the unit level and through the CLI app.
"""

import numpy as np
import pathlib
import pytest

from ipu_path_trace_tpu.film.debugview import (
    DEBUG_VIEWS, debug_ldr, debug_view, mean_path_length,
)


def test_mean_path_length_scatter():
    # 2x3 image; one padding record (u=0xFFFF) and one zero-count record
    # must be skipped exactly like Film.accumulate's bounds.
    u = np.array([0, 1, 2, 0xFFFF, 2], np.uint16)
    v = np.array([0, 0, 1, 0, 0], np.uint16)
    pl = np.array([6, 9, 30, 5, 7], np.uint16)
    cnt = np.array([2, 3, 10, 1, 0], np.uint16)
    out = mean_path_length(u, v, pl, cnt, width=3, height=2)
    assert out.shape == (2, 3)
    assert out[0, 0] == pytest.approx(3.0)
    assert out[0, 1] == pytest.approx(3.0)
    assert out[1, 2] == pytest.approx(3.0)
    assert out[0, 2] == 0.0  # zero-count record skipped
    assert out.sum() == pytest.approx(9.0)  # padding record skipped


def test_debug_view_modes():
    h, w = 2, 2
    guides = {
        "normal": np.array([[[0, 1, 0], [0, -1, 0]],
                            [[1, 0, 0], [-1, 0, 0]]], np.float32),
        "albedo": np.full((h, w, 3), 0.25, np.float32),
        "disparity": np.array([[0.0, 0.5], [1.0, 0.25]], np.float32),
        "escape_uv": np.array([[[0.1, 0.2], [0.3, 0.4]],
                               [[0.5, 0.6], [0.7, 0.8]]], np.float32),
        "hit": np.array([[False, True], [True, False]]),
    }
    n = debug_view("normal", guides)
    assert n.min() >= 0.0 and n.max() <= 1.0
    np.testing.assert_allclose(n[0, 0], [0.5, 1.0, 0.5])
    a = debug_view("albedo", guides)
    np.testing.assert_array_equal(a, guides["albedo"])
    d = debug_view("depth", guides)
    assert d.shape == (h, w, 3)
    np.testing.assert_array_equal(d[..., 0], guides["disparity"])
    np.testing.assert_array_equal(d[..., 1], d[..., 2])
    uv = debug_view("escape-uv", guides)
    np.testing.assert_allclose(uv[0, 0], [0.1, 0.2, 0.0])  # escaped: RG=uv
    np.testing.assert_array_equal(uv[0, 1], 0.0)  # hit: zeroed (ref :345)
    np.testing.assert_allclose(uv[1, 1], [0.7, 0.8, 0.0], rtol=1e-6)
    plm = np.array([[2.0, 4.0], [20.0, 0.0]], np.float32)
    hmap = debug_view("path-length", guides, plm, max_path_length=10)
    np.testing.assert_allclose(hmap[..., 0], [[0.2, 0.4], [1.0, 0.0]])
    with pytest.raises(ValueError, match="unknown debug view"):
        debug_view("radiance", guides)
    with pytest.raises(ValueError, match="path-length"):
        debug_view("path-length", guides)  # needs the live worklist
    ldr = debug_ldr(uv, gamma=1.0)
    assert ldr.dtype == np.uint8
    assert ldr[0, 0, 0] == round(0.1 * 255)
    assert set(DEBUG_VIEWS) == {"normal", "albedo", "depth", "path-length",
                                "escape-uv"}


def _run_app(outfile, extra, scene_json=None):
    from ipu_path_trace_tpu.runtime.app import PathTracerApp
    from ipu_path_trace_tpu.runtime.cli import parse_config

    argv = ["-o", str(outfile), "-w", "32", "--height", "32",
            "-s", "4", "--samples-per-step", "4",
            "--assets", "constant:0.6,0.5,0.4", "--seed", "3"]
    if scene_json:
        argv += ["--scene", scene_json]
    cfg = parse_config(argv + extra)
    app = PathTracerApp(cfg)
    app.init()
    app.build()
    return app.execute()


def test_cli_debug_view_end_to_end(tmp_path):
    """--debug-view escape-uv writes the UV diagnostic through the app;
    the Monte-Carlo accumulator is untouched (save-path only)."""
    import math

    from ipu_path_trace_tpu.core.scene import default_scene
    from ipu_path_trace_tpu.film.denoise import primary_features
    from ipu_path_trace_tpu.film.imageio import read_exr

    film_raw = _run_app(tmp_path / "raw.png", [])
    film_dbg = _run_app(tmp_path / "uv.png", ["--debug-view", "escape-uv"])
    np.testing.assert_array_equal(film_raw.hdr, film_dbg.hdr)

    img = read_exr(str((tmp_path / "uv.png").with_suffix(".exr")))
    guides = primary_features(default_scene(), 32, 32, math.radians(90.0))
    expect = debug_view("escape-uv", guides)
    np.testing.assert_allclose(img, expect, atol=1e-6)
    hit = np.asarray(guides["hit"])
    assert hit.any() and (~hit).any()  # both branches exercised
    assert (img[hit] == 0.0).all()
    assert (img[~hit][:, :2] > 0.0).all()  # escaped: RG = equirect uv


def test_cli_debug_view_path_length(tmp_path):
    img_path = tmp_path / "pl.png"
    _run_app(img_path, ["--debug-view", "path-length"])
    from ipu_path_trace_tpu.film.imageio import read_exr

    img = read_exr(str(img_path.with_suffix(".exr")))
    assert img.shape == (32, 32, 3)
    assert img.min() >= 0.0 and img.max() <= 1.0
    # Every pixel terminates with >= 1 stack push per sample, so the
    # mean path length over max_path_length=10 is at least 0.1:
    assert img[..., 0].min() >= 0.1 - 1e-6
    np.testing.assert_array_equal(img[..., 0], img[..., 1])
