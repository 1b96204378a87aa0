"""End-to-end determinism: identical config => bitwise-identical film.

This pins the property at small scale, for both the step-wise and the
device-resident loop, which must also agree with each other exactly
when run twice (their mutual agreement to float tolerance is covered by
test_device_film).
"""

import numpy as np

from ipu_path_trace_tpu.runtime.app import PathTracerApp
from ipu_path_trace_tpu.runtime.config import Config


def _render(tmp_path, tag: str, device_film: bool) -> np.ndarray:
    cfg = Config(
        outfile=str(tmp_path / f"det_{tag}.png"),
        assets="constant:0.7,0.6,0.9",
        width=16,
        height=16,
        samples=4,
        samples_per_step=2,
        seed=9,
        device_film=device_film,
    )
    app = PathTracerApp(cfg)
    app.init()
    app.build()
    film = app.execute()
    steps = cfg.rounded_samples_per_pixel() // cfg.samples_per_step
    return film.hdr_at_step(1 if device_film else steps)


def test_stepwise_render_is_deterministic(tmp_path):
    a = _render(tmp_path, "a", device_film=False)
    b = _render(tmp_path, "b", device_film=False)
    np.testing.assert_array_equal(a, b)
    assert a.max() > 0


def test_device_film_render_is_deterministic(tmp_path):
    a = _render(tmp_path, "da", device_film=True)
    b = _render(tmp_path, "db", device_film=True)
    np.testing.assert_array_equal(a, b)
    assert a.max() > 0
