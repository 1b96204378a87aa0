"""chip_smoke.py's CPU-side behaviour: it refuses to run without a GPU,
its result line has the agreed form, and its four-card replay check
holds on four virtual CPU devices."""

import importlib.util
import json
import pathlib

import jax
import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_refuses_non_gpu_backend():
    smoke = _smoke()
    with pytest.raises(smoke.SmokeError, match="no GPU"):
        smoke.check_device(jax.devices())


def test_main_fails_without_gpu(capsys):
    assert _smoke().main([]) != 0
    out = capsys.readouterr().out
    assert '"ok"' not in out


def test_last_line_format():
    line = _smoke().last_line("gpu", "NVIDIA H100 80GB HBM3", 1)
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}
    assert "\n" not in line


def test_optional_imports_reported():
    found = _smoke().optional_imports()
    assert set(found) == {"h5py", "PIL", "imageio"}
    assert all(isinstance(v, bool) for v in found.values())


@pytest.mark.parametrize("shape", ["4x1", "2x2"])
def test_mesh_replay_on_four_devices(tmp_path, shape):
    """The --cards 4 phase at a tiny frame: tpu_trace --ipus 4 equals
    the one-device replay of every shard."""
    smoke = _smoke()
    argv = ["-w", "24", "-H", "16", "-s", "4", "--samples-per-step", "2",
            "--save-interval", "2", "--device-film", "--assets",
            str(REPO / "assets" / "nif_w128")]
    r = smoke.mesh_replay(argv, shape, 4, str(tmp_path))
    assert r["max_rel"] < 1e-5
    assert r["path_length_equal"] == 1.0
