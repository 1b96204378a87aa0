"""Multi-chip sharding of the render step over a device mesh.

Replacement for the reference's per-IPU virtual graphs
(reference: src/shard_utils.cpp:28-38, src/PathTracerApp.cpp:205-252):

  * "pixels" mesh axis: the worklist is sharded; each chip traces its
    own pixel slice with its own NIF replica, so no ray data ever
    crosses chips - the exact design intent of the reference
    (PathTracerApp.cpp:205-207).
  * "samples" mesh axis: chips render the SAME pixels with different
    sample streams; radiance/statistics are psum-reduced (an all-reduce
    over the device interconnect, NVLink on a GPU host) into every
    replica's worklist copy (the film reduction).

``make_mesh`` takes the first N devices in order: on a host whose cards
are joined all to all the layout needs no topology awareness.

Environment-light weights (NIF) are replicated to every chip - one
replica per chip, weights shared from the host exactly like the
reference's shared NifModel::Data (PathTracerApp.cpp:110-115).
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.records import WorkBatch
from ..render.params import RenderSettings, StaticConfig
from ..render.wavefront import render_step_impl


def parse_mesh_shape(mesh_shape: str, num_devices: int) -> tuple[int, int]:
    """'4x2' -> (4, 2); '' -> (num_devices, 1)."""
    if not mesh_shape:
        return (num_devices, 1)
    parts = mesh_shape.lower().split("x")
    if len(parts) != 2:
        raise ValueError(f"mesh-shape must be 'PIXELSxSAMPLES', got '{mesh_shape}'")
    px, sm = int(parts[0]), int(parts[1])
    if px * sm != num_devices:
        raise ValueError(
            f"mesh-shape {px}x{sm} needs {px * sm} devices but {num_devices} requested"
        )
    return (px, sm)


def make_mesh(num_devices: int | None = None, mesh_shape: str = "") -> Mesh:
    devices = jax.devices()
    n = num_devices or len(devices)
    if n > len(devices):
        raise ValueError(f"Requested {n} chips but only {len(devices)} available.")
    px, sm = parse_mesh_shape(mesh_shape, n)
    dev_grid = np.asarray(devices[:n]).reshape(px, sm)
    return Mesh(dev_grid, axis_names=("pixels", "samples"))


def sharded_render_step_impl(
    scene,
    settings: RenderSettings,
    cfg: StaticConfig,
    work: WorkBatch,
    step_key: jax.Array,
    env,
    mesh: Mesh,
) -> WorkBatch:
    """Run one render step sharded over the mesh.

    cfg.samples_per_step is the per-chip sample count; the combined step
    takes samples_per_step * mesh.shape['samples'] samples per pixel.
    The worklist's leading dim must divide by mesh.shape['pixels'].
    """
    n_px = mesh.shape["pixels"]
    if int(work.u.shape[0]) % n_px:
        raise ValueError(
            f"Worklist size {int(work.u.shape[0])} not divisible by pixel-axis size {n_px}."
        )

    def local_step(scene_r, settings_r, env_r, work_local: WorkBatch, key: jax.Array) -> WorkBatch:
        # Decorrelate RNG across the mesh (sobol mode additionally
        # offsets sequence indices by the samples-axis position so the
        # replicas draw disjoint slices - render_step_impl docstring):
        key = jax.random.fold_in(key, jax.lax.axis_index("pixels"))
        key = jax.random.fold_in(key, jax.lax.axis_index("samples"))
        out = render_step_impl(
            scene_r, settings_r, cfg, work_local, key, env_r,
            sample_axis_index=jax.lax.axis_index("samples"),
        )
        # Film reduction over the sample axis (psum): radiance sums,
        # sample counts and path lengths all add.
        reduce = lambda x: jax.lax.psum(x, "samples")
        return WorkBatch(
            u=work_local.u,
            v=work_local.v,
            r=work_local.r + reduce(out.r - work_local.r),
            g=work_local.g + reduce(out.g - work_local.g),
            b=work_local.b + reduce(out.b - work_local.b),
            sample_count=work_local.sample_count
            + reduce(out.sample_count - work_local.sample_count),
            path_length=work_local.path_length
            + reduce(out.path_length - work_local.path_length),
        )

    shard = P("pixels")
    repl = P()
    work_specs = WorkBatch(*([shard] * len(work)))  # type: ignore[arg-type]
    spec_of = lambda tree: jax.tree.map(lambda _: repl, tree)
    fn = jax.shard_map(
        local_step,
        mesh=mesh,
        in_specs=(spec_of(scene), spec_of(settings), spec_of(env), work_specs, repl),
        out_specs=work_specs,
        check_vma=False,
    )
    return fn(scene, settings, env, work, step_key)


sharded_render_step = partial(jax.jit, static_argnames=("cfg", "mesh"))(
    sharded_render_step_impl
)


def make_step_fn(cfg: StaticConfig, mesh: Mesh | None = None,
                 rng_impl: str = "threefry2x32"):
    """Build the jitted render-step callable for a config + optional mesh.

    The static config (and mesh) are closed over so the returned function
    takes only array pytrees - which makes it directly AOT-exportable
    (runtime/exe_cache.ProgramManager.save).
    Signature: fn(scene, settings, work, step_key, env) -> WorkBatch.

    ``step_key`` may be a typed PRNG key or its raw ``jax.random.key_data``
    words.  AOT callers MUST pass raw data: a typed-key argument makes the
    deserialised program fail at call time (Shardy rejects the replicated
    sharding on the opaque key - rank 0 spec vs rank 1 key data), so the
    wrap happens inside the traced function with the static ``rng_impl``.
    """

    def as_key(k):
        if jnp.issubdtype(k.dtype, jax.dtypes.prng_key):
            return k
        return jax.random.wrap_key_data(k, impl=rng_impl)

    if mesh is None:

        def fn(scene, settings, work, step_key, env):
            return render_step_impl(scene, settings, cfg, work, as_key(step_key), env)

    else:

        def fn(scene, settings, work, step_key, env):
            return sharded_render_step_impl(
                scene, settings, cfg, work, as_key(step_key), env, mesh
            )

    return jax.jit(fn)


def shard_work(work: WorkBatch, mesh: Mesh) -> WorkBatch:
    """Place worklist arrays with the pixel sharding (donation-friendly)."""
    sharding = NamedSharding(mesh, P("pixels"))
    return WorkBatch(*(jax.device_put(x, sharding) for x in work))


def replicate(tree, mesh: Mesh):
    """Replicate scene/env/settings pytrees across the mesh."""
    sharding = NamedSharding(mesh, P())
    return jax.tree.map(lambda x: jax.device_put(x, sharding), tree)
