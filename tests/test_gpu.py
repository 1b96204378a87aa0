"""Card-only tier: checks that mean something only on a GPU.

Every test takes the ``gpu_device`` fixture (tests/conftest.py), which
skips where there is no card.  Run on the card with
``python chip_smoke.py`` (phase 6) or
``JAX_PLATFORMS=cuda python -m pytest tests -m gpu``.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from ipu_path_trace_tpu.core.records import make_worklist, to_device_batch
from ipu_path_trace_tpu.core.scene import default_scene
from ipu_path_trace_tpu.cpu import nif_forward
from ipu_path_trace_tpu.models.envlight import ConstantEnv, NifEnv
from ipu_path_trace_tpu.models.nif import load_nif_assets, make_params, nif_apply
from ipu_path_trace_tpu.render.params import RenderSettings, StaticConfig
from ipu_path_trace_tpu.render.wavefront import render_step

ASSET = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "assets", "urban_alley_synth_nif")

pytestmark = pytest.mark.gpu


def _uv(n=4096, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 1, n).astype(np.float32),
            rng.uniform(0, 1, n).astype(np.float32))


def test_float32_matmuls_need_highest_precision(gpu_device):
    """The card runs float32 products in TF32 unless asked otherwise:
    at "highest" the NIF chain matches float32 NumPy to 1e-4, at the
    default it does not - which is why every float32 reference here
    sets the precision explicitly."""
    _, meta, weights = load_nif_assets(ASSET)
    p32 = make_params(weights, meta, jnp.float32)
    u, v = _uv()
    ref = nif_forward(weights, meta, u, v)
    apply = jax.jit(nif_apply)
    with jax.default_matmul_precision("highest"):
        hi = np.asarray(apply(p32, jnp.asarray(u), jnp.asarray(v)))
    lo = np.asarray(apply(p32, jnp.asarray(u), jnp.asarray(v)))
    assert (np.abs(hi - ref) / np.abs(ref)).max() < 1e-4
    assert (np.abs(lo - ref) / np.abs(ref)).max() > 1e-4


def test_int8_dot_is_exact(gpu_device):
    """int8 x int8 -> int32 products (the --nif-precision int8 chain)
    are exact integers on the card."""
    rng = np.random.default_rng(1)
    a = rng.integers(-127, 128, (320, 368), dtype=np.int8)
    b = rng.integers(-127, 128, (368, 4096), dtype=np.int8)
    dn = (((1,), (0,)), ((), ()))
    got = jax.jit(lambda x, y: jax.lax.dot_general(
        x, y, dn, preferred_element_type=jnp.int32))(a, b)
    np.testing.assert_array_equal(np.asarray(got),
                                  a.astype(np.int64) @ b.astype(np.int64))


@pytest.mark.parametrize("env_kind", ["constant", "nif"])
def test_render_step_card_matches_cpu(gpu_device, env_kind):
    """The same step on the card and on the CPU backend: identical
    random streams, so the images agree except for the few lanes whose
    roulette/Fresnel decision a last-ulp difference flips."""
    w = h = 48
    scene = default_scene()
    cfg = StaticConfig(width=w, height=h)
    settings = RenderSettings.make(samples_per_step=4)
    if env_kind == "nif":
        _, meta, weights = load_nif_assets(ASSET)
        env = NifEnv(params=make_params(weights, meta, jnp.float32))
    else:
        env = ConstantEnv(colour=jnp.asarray([1.0, 0.8, 0.6]))
    work = to_device_batch(make_worklist(w, h))
    key = jax.random.key(3)
    cpu = jax.devices("cpu")[0]
    imgs = []
    for dev in (gpu_device, cpu):
        args = jax.device_put((scene, settings, work, key, env), dev)
        with jax.default_matmul_precision("highest"):
            out = render_step(args[0], args[1], cfg, args[2], args[3], args[4])
        imgs.append(np.stack([np.asarray(out.r), np.asarray(out.g),
                              np.asarray(out.b)], -1))
    err = (np.abs(imgs[0] - imgs[1]) / np.maximum(np.abs(imgs[1]), 1.0)).max(-1)
    assert (err <= 1e-3).mean() >= 0.99
