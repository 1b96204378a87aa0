"""Multi-chip sharding tests on the 8-device virtual CPU mesh."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from ipu_path_trace_tpu.core.records import make_worklist, to_device_batch
from ipu_path_trace_tpu.core.scene import default_scene
from ipu_path_trace_tpu.models.envlight import ConstantEnv
from ipu_path_trace_tpu.parallel.mesh import (
    make_mesh,
    parse_mesh_shape,
    replicate,
    shard_work,
    sharded_render_step,
)
from ipu_path_trace_tpu.render.params import RenderSettings, StaticConfig
from ipu_path_trace_tpu.render.wavefront import render_step

W, H = 32, 24


def _run(mesh, samples_local):
    scene = replicate(default_scene(), mesh)
    env = replicate(ConstantEnv(colour=jnp.asarray([1.0, 0.9, 0.8])), mesh)
    cfg = StaticConfig(width=W, height=H)
    work = shard_work(to_device_batch(make_worklist(W, H)), mesh)
    out = sharded_render_step(
        scene, RenderSettings.make(samples_per_step=samples_local), cfg, work,
        jax.random.key(3), env, mesh,
    )
    jax.block_until_ready(out)
    return out


def test_parse_mesh_shape():
    assert parse_mesh_shape("", 8) == (8, 1)
    assert parse_mesh_shape("4x2", 8) == (4, 2)
    with pytest.raises(ValueError):
        parse_mesh_shape("3x2", 8)


def test_pixel_sharding():
    mesh = make_mesh(8, "8x1")
    out = _run(mesh, 4)
    assert (np.asarray(out.sample_count) == 4).all()
    assert np.asarray(out.r).mean() > 0.0
    assert np.isfinite(np.asarray(out.r)).all()


def test_sample_axis_psum():
    """2 sample-replicas x 2 local samples == 4 samples accumulated."""
    mesh = make_mesh(8, "4x2")
    out = _run(mesh, 2)
    # psum over the sample axis doubles the local count:
    assert (np.asarray(out.sample_count) == 4).all()
    assert np.asarray(out.path_length).sum() > 0


def test_multichip_matches_singlechip_statistically():
    """Sharded and single-chip renders agree in expectation.  (The exact
    tests below pin equality against a replay of the same streams; this
    one alone cross-checks against an INDEPENDENT stream, so it would
    catch a bias that the replays share.)  Image-mean MC error at
    768 px x 16 spp is ~1%, so 5% is ~5 sigma."""
    mesh = make_mesh(8, "4x2")
    out_multi = _run(mesh, 8)  # 16 effective spp
    scene = default_scene()
    env = ConstantEnv(colour=jnp.asarray([1.0, 0.9, 0.8]))
    cfg = StaticConfig(width=W, height=H)
    out_single = render_step(
        scene, RenderSettings.make(samples_per_step=16), cfg,
        to_device_batch(make_worklist(W, H)), jax.random.key(9), env,
    )
    m_multi = np.asarray(out_multi.r).sum() / np.asarray(out_multi.sample_count).sum()
    m_single = np.asarray(out_single.r).sum() / np.asarray(out_single.sample_count).sum()
    assert abs(m_multi - m_single) / max(m_single, 1e-9) < 0.05


def _simulate_sharded(scene, settings, cfg, work, key, env, n_px, n_sm):
    """Single-device replay of the sharded semantics: slice the worklist
    like the pixel axis, fold the key like mesh.local_step does, and sum
    sample-replica deltas like psum."""
    from ipu_path_trace_tpu.core.records import WorkBatch

    n = work.u.shape[0]
    per = n // n_px
    outs = []
    for i in range(n_px):
        sl = jax.tree.map(lambda x: x[i * per : (i + 1) * per], work)
        acc = None
        for s in range(n_sm):
            k = jax.random.fold_in(jax.random.fold_in(key, i), s)
            o = render_step(scene, settings, cfg, sl, k, env)
            delta = jax.tree.map(lambda a, b: a - b, o, sl)
            acc = delta if acc is None else jax.tree.map(lambda a, b: a + b, acc, delta)
        outs.append(jax.tree.map(lambda a, b: a + b, sl, acc))
    return WorkBatch(
        *[jnp.concatenate([getattr(o, f) for o in outs]) for f in WorkBatch._fields]
    )


def _nif_env():
    from ipu_path_trace_tpu.models.envlight import NifEnv
    from ipu_path_trace_tpu.models.nif import make_params, make_synthetic_nif

    weights, meta = make_synthetic_nif(key=0, hidden=32, num_hidden=2, skip_layer=1)
    return NifEnv(params=make_params(weights, meta, jnp.bfloat16))


@pytest.mark.parametrize(
    "shape,env_kind",
    [("8x1", "const"), ("4x2", "const"), ("4x2", "nif"), ("2x4", "nif")],
)
def test_sharded_equals_singlechip_exactly(shape, env_kind):
    """The sharded render must EQUAL the single-device replay of the same
    fold_in-derived streams - the correctness property psum + fold_in
    must preserve (reference multi-IPU intent: PathTracerApp.cpp:205-252)."""
    n_px, n_sm = parse_mesh_shape(shape, 8)
    mesh = make_mesh(8, shape)
    scene = default_scene()
    env = _nif_env() if env_kind == "nif" else ConstantEnv(
        colour=jnp.asarray([1.0, 0.9, 0.8])
    )
    cfg = StaticConfig(width=W, height=H)
    settings = RenderSettings.make(samples_per_step=2)
    work = to_device_batch(make_worklist(W, H))
    key = jax.random.key(7)

    out_sharded = sharded_render_step(
        replicate(scene, mesh), settings, cfg, shard_work(work, mesh),
        key, replicate(env, mesh), mesh,
    )
    out_single = _simulate_sharded(scene, settings, cfg, work, key, env, n_px, n_sm)

    for f in out_single._fields:
        a = np.asarray(getattr(out_sharded, f))
        b = np.asarray(getattr(out_single, f))
        if n_sm == 1:
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            # psum may associate the cross-replica adds differently:
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7, err_msg=f)


def test_sharded_uneven_padding_matches_singlechip():
    """Padded worklists (pixel count not divisible by the mesh) shard and
    render identically to the single-device replay; padding records keep
    DUMMY coords so the film skips them."""
    w, h = 10, 7  # 70 pixels -> pad to 72 for an 8-way pixel axis
    mesh = make_mesh(8, "8x1")
    scene = default_scene()
    env = ConstantEnv(colour=jnp.asarray([0.8, 0.8, 1.0]))
    cfg = StaticConfig(width=w, height=h)
    settings = RenderSettings.make(samples_per_step=2)
    work = to_device_batch(make_worklist(w, h, padded_size=72))
    key = jax.random.key(11)

    out_sharded = sharded_render_step(
        replicate(scene, mesh), settings, cfg, shard_work(work, mesh),
        key, replicate(env, mesh), mesh,
    )
    out_single = _simulate_sharded(scene, settings, cfg, work, key, env, 8, 1)
    for f in out_single._fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(out_sharded, f)), np.asarray(getattr(out_single, f)),
            err_msg=f,
        )
    # Padding records really are dummies:
    assert (np.asarray(out_sharded.u)[70:] == 0xFFFF).all()


@pytest.mark.parametrize("env_kind", ["const", "nif"])
@pytest.mark.parametrize("shape", ["4x1", "2x2", "1x4"])
def test_four_device_replay(shape, env_kind):
    """The four-card layouts (chip_smoke.py --cards 4) on four virtual
    devices: each shard equals a one-device render_step of its worklist
    slice with the key local_step folds, summed over the samples axis."""
    n_px, n_sm = parse_mesh_shape(shape, 4)
    mesh = make_mesh(4, shape)
    scene = default_scene()
    env = _nif_env() if env_kind == "nif" else ConstantEnv(
        colour=jnp.asarray([0.9, 1.0, 0.7]))
    cfg = StaticConfig(width=W, height=H)
    settings = RenderSettings.make(samples_per_step=2)
    work = to_device_batch(make_worklist(W, H))
    key = jax.random.key(29)

    out_sharded = sharded_render_step(
        replicate(scene, mesh), settings, cfg, shard_work(work, mesh),
        key, replicate(env, mesh), mesh,
    )
    out_single = _simulate_sharded(scene, settings, cfg, work, key, env, n_px, n_sm)
    for f in out_single._fields:
        a = np.asarray(getattr(out_sharded, f))
        b = np.asarray(getattr(out_single, f))
        if n_sm == 1:
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            # psum may associate the cross-replica adds differently:
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7, err_msg=f)
    assert (np.asarray(out_sharded.sample_count) == 2 * n_sm).all()


def test_worklist_divisibility_error():
    mesh = make_mesh(8, "8x1")
    scene = replicate(default_scene(), mesh)
    env = replicate(ConstantEnv(colour=jnp.asarray([1.0, 1.0, 1.0])), mesh)
    cfg = StaticConfig(width=3, height=3)
    work = to_device_batch(make_worklist(3, 3))  # 9 not divisible by 8
    with pytest.raises(ValueError):
        sharded_render_step(
            scene, RenderSettings.make(samples_per_step=1), cfg, work,
            jax.random.key(0), env, mesh,
        )


def test_graft_dryrun():
    import importlib.util, pathlib

    spec = importlib.util.spec_from_file_location(
        "__graft_entry__", pathlib.Path(__file__).parent.parent / "__graft_entry__.py"
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.dryrun_multichip(8)
