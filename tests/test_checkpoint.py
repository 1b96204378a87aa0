"""Mid-render checkpoint / resume (--checkpoint / --resume).

The contract (runtime/checkpoint.py): an interrupted-and-resumed
headless render produces BITWISE-identical results to an uninterrupted
one, in both film modes, because step keys are fold_in(base, step) and
accumulation order is preserved.  The reference can only restart from
scratch (PathTracerApp.cpp:652-686).
"""

import numpy as np
import pytest

from ipu_path_trace_tpu.runtime.app import PathTracerApp
from ipu_path_trace_tpu.runtime.checkpoint import (
    load_checkpoint,
    save_checkpoint,
)
from ipu_path_trace_tpu.runtime.config import Config


def _cfg(tmp_path, tag, **kw):
    base = dict(
        outfile=str(tmp_path / f"ck_{tag}.png"),
        assets="constant:0.8,0.7,0.6",
        width=16,
        height=16,
        samples=8,
        samples_per_step=2,
        save_interval=2,
        seed=5,
    )
    base.update(kw)
    return Config(**base)


def _run(cfg, max_steps=None):
    app = PathTracerApp(cfg)
    app.init()
    app.build()
    return app.execute(max_steps=max_steps)


@pytest.mark.parametrize("device_film", [False, True])
def test_resume_bitwise_identical(tmp_path, device_film):
    """4 steps straight == 2 steps + checkpoint + resume 2 steps, bitwise."""
    tag = f"df{device_film}"
    full = _run(_cfg(tmp_path, f"full_{tag}", device_film=device_film))
    full_hdr = full.hdr_at_step(1 if device_film else 4).copy()

    ck = str(tmp_path / f"state_{tag}.npz")
    _run(
        _cfg(tmp_path, f"a_{tag}", device_film=device_film, checkpoint=ck),
        max_steps=2,
    )
    second = _run(
        _cfg(tmp_path, f"b_{tag}", device_film=device_film, resume=ck)
    )
    resumed_hdr = second.hdr_at_step(1 if device_film else 4)
    np.testing.assert_array_equal(resumed_hdr, full_hdr)
    # The resumed run saves -o images at completion:
    assert (tmp_path / f"ck_b_{tag}.png").exists()
    assert (tmp_path / f"ck_b_{tag}.exr").exists()


def test_resume_on_mesh_bitwise(tmp_path):
    """Device-film resume re-shards the restored worklist across the
    8-device mesh and still reproduces the uninterrupted run exactly."""
    import jax

    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device CPU mesh (tests/conftest.py)")
    mesh_kw = dict(device_film=True, ipus=8)
    full = _run(_cfg(tmp_path, "mfull", **mesh_kw))
    full_hdr = full.hdr_at_step(1).copy()
    ck = str(tmp_path / "mesh_state.npz")
    _run(_cfg(tmp_path, "ma", checkpoint=ck, **mesh_kw), max_steps=2)
    second = _run(_cfg(tmp_path, "mb", resume=ck, **mesh_kw))
    np.testing.assert_array_equal(second.hdr_at_step(1), full_hdr)


def test_resume_rejects_mismatched_config(tmp_path):
    ck = str(tmp_path / "state.npz")
    _run(_cfg(tmp_path, "base", checkpoint=ck), max_steps=2)
    with pytest.raises(ValueError, match="does not match"):
        _run(_cfg(tmp_path, "other", seed=6, resume=ck))


def test_checkpoint_written_at_exit_between_intervals(tmp_path):
    """max_steps=3 with save_interval=2: the exit path must checkpoint
    step 3 (the last completed step), not leave step 2's file."""
    ck = str(tmp_path / "state.npz")
    cfg = _cfg(tmp_path, "exit", checkpoint=ck)
    _run(cfg, max_steps=3)
    step, mode, state = load_checkpoint(ck, cfg)
    assert step == 3 and mode == "hdr" and "hdr" in state


def test_checkpoint_validation():
    cfg = Config(assets="constant:1,1,1", checkpoint="x.npz")
    with pytest.raises(ValueError, match="exactly one"):
        save_checkpoint("x.npz", cfg, 1)


def test_resume_load_balancing_bitwise(tmp_path):
    """--checkpoint/--resume compose with --enable-load-balancing: the
    checkpoint carries both double-buffer re-deal layouts (two-buffer
    lag; checkpoint.py module docstring), so the resumed run replays the
    exact same per-step worklist layouts and the film is bitwise equal
    to an uninterrupted run."""
    lb = dict(enable_load_balancing=True, samples=12)  # 6 steps of re-deals
    full = _run(_cfg(tmp_path, "lb_full", **lb))
    full_hdr = full.hdr_at_step(6).copy()

    ck = str(tmp_path / "lb_state.npz")
    _run(_cfg(tmp_path, "lb_a", checkpoint=ck, **lb), max_steps=3)
    second = _run(_cfg(tmp_path, "lb_b", resume=ck, **lb))
    np.testing.assert_array_equal(second.hdr_at_step(6), full_hdr)


def test_resume_load_balancing_needs_layouts(tmp_path):
    """A checkpoint written WITHOUT load balancing cannot seed a
    load-balancing resume: the fingerprint catches the mismatch."""
    ck = str(tmp_path / "plain.npz")
    _run(_cfg(tmp_path, "plain", checkpoint=ck), max_steps=2)
    with pytest.raises(ValueError, match="does not match"):
        _run(_cfg(tmp_path, "lb_res", resume=ck,
                  enable_load_balancing=True))


def test_resume_layout_fingerprinted(tmp_path):
    """Per-lane noise is position-keyed, so the worklist layout is
    numerics-affecting: a raster checkpoint must not seed a coherent
    resume, and a checkpoint that PREDATES the --layout field (no key in
    its fingerprint) must only match the raster behaviour it had."""
    import json

    ck = str(tmp_path / "lay.npz")
    _run(_cfg(tmp_path, "lay_a", layout="coherent", checkpoint=ck),
         max_steps=2)
    with pytest.raises(ValueError, match="does not match"):
        _run(_cfg(tmp_path, "lay_b", layout="raster", resume=ck))

    # Rewrite the checkpoint as if written before --layout existed:
    with np.load(ck) as z:
        arrays = {k: z[k] for k in z.files}
    meta = json.loads(bytes(arrays["meta"].tobytes()).decode())
    del meta["fingerprint"]["layout"]
    arrays["meta"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    np.savez(ck, **arrays)
    with pytest.raises(ValueError, match="does not match"):
        _run(_cfg(tmp_path, "lay_c", layout="coherent", resume=ck))
    # ... while the raster behaviour those checkpoints had still resumes:
    _run(_cfg(tmp_path, "lay_d", layout="raster", resume=ck))


def test_sigterm_graceful_save(tmp_path):
    """Preemption safety: SIGTERM mid-render must exit 0 after writing
    the -o images and the --checkpoint state (a preempted job resumes
    instead of losing completed samples)."""
    import os
    import signal
    import subprocess
    import sys
    import time

    out = tmp_path / "pre.png"
    ck = tmp_path / "pre.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, "-m", "ipu_path_trace_tpu.runtime.cli",
         "-w", "64", "-H", "64", "-s", "400", "--samples-per-step", "2",
         "--save-interval", "1000", "--model",
         "--assets", "constant:0.8,0.7,0.6",
         "--checkpoint", str(ck), "-o", str(out)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    try:
        # Wait until at least one step completed, then preempt.  The
        # reader runs in a thread so a silently hung child (no output at
        # all) still hits the deadline instead of blocking readline:
        import threading

        lines = []
        step_seen = threading.Event()

        def _reader():
            for line in proc.stdout:
                lines.append(line)
                if "Completed render step" in line:
                    step_seen.set()

        rt = threading.Thread(target=_reader, daemon=True)
        rt.start()
        assert step_seen.wait(timeout=300), "".join(lines[-20:])
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=120)
        rt.join(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
    log = "".join(lines)
    assert proc.returncode == 0, log
    assert "Stop requested" in log, log
    assert out.exists() and (tmp_path / "pre.exr").exists(), log
    assert ck.exists(), log
    from ipu_path_trace_tpu.runtime.checkpoint import load_checkpoint
    from ipu_path_trace_tpu.runtime.config import Config

    cfg = Config(assets="constant:0.8,0.7,0.6", width=64, height=64,
                 samples=400, samples_per_step=2, model=True)
    step, mode, state = load_checkpoint(str(ck), cfg)
    assert step >= 1 and mode == "hdr"


def test_corrupt_checkpoint_rejected(tmp_path):
    """Garbage/truncated files surface one contextual ValueError, not a
    raw zipfile/KeyError traceback."""
    cfg = Config(assets="constant:1,1,1")
    bad = tmp_path / "garbage.npz"
    bad.write_bytes(b"not an npz at all")
    with pytest.raises(ValueError, match="unreadable"):
        load_checkpoint(str(bad), cfg)
    # Valid npz, wrong contents:
    import numpy as np

    np.savez(tmp_path / "wrong.npz", x=np.zeros(3))
    with pytest.raises(ValueError, match="metadata"):
        load_checkpoint(str(tmp_path / "wrong.npz"), cfg)


def test_auto_resume_identical_command(tmp_path):
    """One identical command line: fresh start when no checkpoint exists,
    resume when it does - final result bitwise equals a straight run."""
    full = _run(_cfg(tmp_path, "ar_full"))
    full_hdr = full.hdr_at_step(4).copy()

    ck = str(tmp_path / "ar.npz")
    kw = dict(checkpoint=ck, auto_resume=True)
    _run(_cfg(tmp_path, "ar_a", **kw), max_steps=2)  # fresh (no file yet)
    second = _run(_cfg(tmp_path, "ar_b", **kw))      # resumes from step 2
    np.testing.assert_array_equal(second.hdr_at_step(4), full_hdr)

    # Validation: auto-resume without a checkpoint path is rejected:
    with pytest.raises(ValueError, match="auto-resume"):
        Config(assets="constant:1,1,1", auto_resume=True).validate()
    with pytest.raises(ValueError, match="not both"):
        Config(assets="constant:1,1,1", checkpoint="c.npz",
               resume="r.npz", auto_resume=True).validate()
