"""Smoke coverage for the observability features: --profile-dir (the
PVTI analog: an xprof/XLA profiler trace of the render loop) and
--device-timing (the cycle-counter analog: whole-step device time
logged before the loop).  Both must work headless on any backend."""

import os

import numpy as np

from ipu_path_trace_tpu.runtime.app import PathTracerApp
from ipu_path_trace_tpu.runtime.config import Config


def _base_cfg(tmp_path, **kw):
    base = dict(
        outfile=str(tmp_path / "obs.png"),
        assets="constant:0.8,0.7,0.6",
        width=16,
        height=16,
        samples=4,
        samples_per_step=2,
        seed=3,
    )
    base.update(kw)
    return Config(**base)


def test_profile_dir_writes_trace(tmp_path):
    prof = tmp_path / "trace"
    cfg = _base_cfg(tmp_path, profile_dir=str(prof))
    app = PathTracerApp(cfg)
    app.init()
    app.build()
    film = app.execute()
    assert np.isfinite(film.hdr).all()
    # jax.profiler.start_trace/stop_trace wrote something under the dir:
    found = [os.path.join(r, f) for r, _, fs in os.walk(prof) for f in fs]
    assert found, "profiler trace directory is empty"


def test_device_timing_logs_split(tmp_path):
    import logging

    from ipu_path_trace_tpu.utils.logging import logger

    cfg = _base_cfg(tmp_path, device_timing=True)
    app = PathTracerApp(cfg)
    app.init()
    app.build()
    records = []

    class _Capture(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    h = _Capture()
    logger().addHandler(h)
    try:
        app.execute()
    finally:
        logger().removeHandler(h)
    timing = [m for m in records if "Device step timing" in m]
    assert timing, records[:10]
    assert "step=" in timing[0] and "Mpaths/s" in timing[0]


def test_metrics_file_jsonl(tmp_path):
    """--metrics-file: one parseable JSON line per completed step plus a
    summary line, in both film modes."""
    import json

    for device_film in (False, True):
        mf = tmp_path / f"metrics_{device_film}.jsonl"
        cfg = _base_cfg(tmp_path, metrics_file=str(mf),
                        device_film=device_film)
        app = PathTracerApp(cfg)
        app.init()
        app.build()
        app.execute()
        lines = [json.loads(l) for l in mf.read_text().splitlines()]
        steps = [l for l in lines if "step" in l]
        assert len(steps) == 2  # samples=4 / spp=2
        assert steps[0]["step"] == 1 and steps[0]["samples_per_sec"] > 0
        summary = [l for l in lines if l.get("event") == "summary"]
        assert len(summary) == 1 and summary[0]["total_spp"] == 4
