"""Double-buffered worklists and the path-length load balancer.

Host-side work scheduling, the port of
reference: src/LoadBalancer.{hpp,cpp}.  The wavefront is SIMD, so
static sharding is already balanced; the shuffle/re-deal machinery is
kept for behavioural parity (`--enable-load-balancing`) and because the
record bookkeeping (clear + pathLength reduction for the rays/sec
metric) lives here either way.  Hot loops go through the native C++
runtime when built (csrc/pt_host.cpp), with NumPy fallbacks.

"Tiles" are virtual here: the unit the load balancer deals work to.
The default mirrors the reference's 1472 tiles/chip.
"""

from __future__ import annotations

import numpy as np

from ..core.records import DUMMY_COORD, TRACE_RECORD_DTYPE, make_worklist
from ..utils.logging import logger
from . import native

# The reference's MK2 IPU has 1472 tiles x 6 workers (SURVEY.md section 2.11);
# kept as the virtual tile count for load-balancing parity.
VIRTUAL_TILES = 1472
VIRTUAL_WORKERS = 6


def calculate_max_rays_per_tile(
    width: int, height: int, num_tiles: int = VIRTUAL_TILES, num_workers: int = VIRTUAL_WORKERS
) -> int:
    """Ceil-divide pixels over tiles, round up to a worker multiple.

    Mirrors calculateMaxRaysPerTile (LoadBalancer.cpp:14-36) including its
    quirk of adding `raysPerTile % numWorkers` rather than rounding up to
    the next multiple.
    """
    total = width * height
    if total % (num_tiles * num_workers):
        logger().warning(
            "For best performance number of pixels should be divisible by %d x %d (tiles x workers).",
            num_tiles,
            num_workers,
        )
    rays_per_tile = int(np.ceil(total / float(num_tiles)))
    rays_per_tile += rays_per_tile % num_workers
    return max(num_workers, rays_per_tile)


def create_tracing_jobs(
    width: int, height: int, num_tiles: int = VIRTUAL_TILES, multiple_of: int = 1
) -> np.ndarray:
    """Padded whole-image worklist (createTracingJobs, LoadBalancer.cpp:54-86).

    ``multiple_of`` additionally rounds the padded size up to a multiple
    (set to the mesh pixel-axis size so sharding divides evenly for any
    chip count - padding records are DUMMY_COORD and skipped by the film).
    """
    rays_per_tile = calculate_max_rays_per_tile(width, height, num_tiles)
    size = rays_per_tile * num_tiles
    if multiple_of > 1 and size % multiple_of:
        size += multiple_of - (size % multiple_of)
    return make_worklist(width, height, padded_size=size)


def primary_hit_class(scene, u: np.ndarray, v: np.ndarray,
                      width: int, height: int,
                      fov_degrees: float) -> np.ndarray:
    """Static expected-path-length class of each record's central ray.

    -1 = padding (u == DUMMY_COORD), 0 = primary miss (the path dies on
    bounce 0), 1 = emissive hit, 2 = diffuse, 3 = specular,
    4 = refractive (the clear-coat shells bounce longest).  Computed
    once from the jitter-free central ray, so it is a deterministic
    function of (scene, camera) only.
    """
    import jax.numpy as jnp

    from ..core.camera import pixel_to_ray
    from ..core.geometry import intersect_scene
    from ..core.scene import Material
    from ..core.vecmath import Vec3

    cols = jnp.asarray(u.astype(np.float32))
    rows = jnp.asarray(v.astype(np.float32))
    fov = jnp.float32(np.deg2rad(fov_degrees))  # pixel_to_ray takes radians
    d = pixel_to_ray(cols, rows, width, height, fov).normalized()
    hit = intersect_scene(scene, Vec3.zeros(cols.shape), d)
    key = jnp.where(
        ~hit.valid,
        0,
        jnp.where(
            hit.emissive,
            1,
            jnp.where(
                hit.material == int(Material.DIFFUSE),
                2,
                jnp.where(hit.material == int(Material.SPECULAR), 3, 4),
            ),
        ),
    )
    return np.where(u == DUMMY_COORD, -1, np.asarray(key))


def coherent_order(worklist: np.ndarray, scene, width: int, height: int,
                   fov_degrees: float, shards: int = 1) -> np.ndarray:
    """Reorder records so neighbouring lanes follow the same kind of path.

    The reference's balancer deals (shortest, longest) path pairs to
    every tile to EQUALISE load across its 1472 MIMD tiles
    (LoadBalancer.cpp:141-192).  A SIMD machine wants the opposite:
    lanes that run together should finish together, so records are
    sorted by the primary-hit class of their central ray - a jitter-free
    proxy for expected path length (scripts/coherent_layout_probe.py).

    The sort is stable (raster order breaks ties) so the layout is
    deterministic.  With ``shards`` > 1 the sorted order is dealt
    round-robin into ``shards`` contiguous chunks: each mesh shard gets
    an equal mix of classes (cross-chip balance) while every chunk stays
    internally sorted (a strided subsequence of a sorted list).
    """
    key = primary_hit_class(scene, worklist["u"], worklist["v"],
                            width, height, fov_degrees)
    perm = np.lexsort((np.arange(len(worklist)), key))
    if shards > 1:
        if len(perm) % shards:
            raise ValueError(
                f"worklist size {len(perm)} does not divide into {shards} shards")
        perm = np.concatenate([perm[i::shards] for i in range(shards)])
    return worklist[perm]


class WorkList:
    """Double-buffered record list (LoadBalancer.hpp:26-41).

    The device renders into the active buffer while the host
    asynchronously accumulates the inactive one.
    """

    def __init__(self, size: int):
        self._active = np.zeros(size, TRACE_RECORD_DTYPE)
        self._inactive = np.zeros(size, TRACE_RECORD_DTYPE)

    @property
    def active(self) -> np.ndarray:
        return self._active

    @active.setter
    def active(self, v: np.ndarray) -> None:
        self._active = v

    @property
    def inactive(self) -> np.ndarray:
        return self._inactive

    @inactive.setter
    def inactive(self, v: np.ndarray) -> None:
        self._inactive = v

    def swap(self) -> None:
        self._active, self._inactive = self._inactive, self._active
        if self._active.size == 0:
            raise RuntimeError("The new active worklist is empty.")


class LoadBalancer:
    """Work scheduling state (LoadBalancer struct, LoadBalancer.hpp:43-56)."""

    def __init__(self, work_item_count: int, num_tiles: int = VIRTUAL_TILES):
        self.work = WorkList(work_item_count)
        self.num_tiles = num_tiles

    def randomise_work_list(self, worklist: np.ndarray, seed: int = 142) -> None:
        """Shuffle and install as the inactive list (LoadBalancer.cpp:118-139).

        The reference uses mt19937 seeded with 142; we keep the fixed seed
        for reproducibility (the exact permutation differs - this only
        decorrelates tile assignment).
        """
        shuffled = worklist.copy()
        np.random.default_rng(seed).shuffle(shuffled)
        self.work.inactive = shuffled

    def allocate_work_by_path_length(self) -> None:
        """Deal (shortest, longest) path pairs to each virtual tile.

        allocateWorkByPathLength (LoadBalancer.cpp:141-192): sorts the
        inactive list by pathLength then alternates ends.
        """
        records = self.work.inactive
        if native.load_balance(records, self.num_tiles):
            return
        order = np.argsort(records["pathLength"], kind="stable")
        sorted_recs = records[order]
        n = len(sorted_recs)
        t = max(self.num_tiles, 1)
        # Exact vectorised replay of the C++ deal (csrc/pt_host.cpp
        # pt_load_balance) for ANY n: pair j = (sorted[j], sorted[n-1-j])
        # goes to tile j % t on round j // t; tiles flatten tile-major
        # with their pairs in round order; an odd middle record lands at
        # the end of tile 0's run.
        m = n // 2
        j = np.arange(m, dtype=np.int64)
        by_tile = np.argsort(j % t, kind="stable")  # tile-major, round order
        idx = np.stack([by_tile, n - 1 - by_tile], axis=1).reshape(-1)
        if n % 2:
            tile0_pairs = int((m + t - 1) // t)
            idx = np.insert(idx, 2 * tile0_pairs, m)
        self.work.inactive = sorted_recs[idx]

    def clear_inactive_accumulators(self) -> int:
        """Zero accumulators, returning the pathLength sum for rays/sec.

        Fused like the reference (LoadBalancer.cpp:198-213).
        """
        records = self.work.inactive
        total = native.clear_and_sum_pathlengths(records)
        if total is not None:
            return total
        total = int(records["pathLength"].sum())
        records["r"] = 0
        records["g"] = 0
        records["b"] = 0
        records["sampleCount"] = 0
        records["pathLength"] = 0
        return total

    def clear_active_accumulators(self) -> None:
        records = self.work.active
        records["r"] = 0
        records["g"] = 0
        records["b"] = 0
        records["sampleCount"] = 0
        records["pathLength"] = 0
