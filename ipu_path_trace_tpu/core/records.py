"""Trace-record work items: SoA on device, 20-byte AoS on the host wire.

The reference streams a packed 20-byte ``TraceRecord`` per pixel both ways
every step (reference: src/codelets/TraceRecord.hpp:7-19).  Here the
device side is SoA arrays (no byte punning), but the host-side worklist
keeps the exact reference memory layout so tooling and the remote UI can
interoperate, and so the host C++ runtime can process it with the same
stride.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax.numpy as jnp

# Exact reference layout: u16 u, v; f32 r, g, b; u16 sampleCount, pathLength.
TRACE_RECORD_DTYPE = np.dtype(
    [
        ("u", "<u2"),
        ("v", "<u2"),
        ("r", "<f4"),
        ("g", "<f4"),
        ("b", "<f4"),
        ("sampleCount", "<u2"),
        ("pathLength", "<u2"),
    ]
)
assert TRACE_RECORD_DTYPE.itemsize == 20, "TraceRecord must stay 20 bytes (TraceRecord.hpp)"

# Worklist padding marker (LoadBalancer.cpp:65-72):
DUMMY_COORD = np.uint16(0xFFFF)


class WorkBatch(NamedTuple):
    """Device-side SoA view of a worklist slice."""

    u: jnp.ndarray  # (P,) int32 pixel column (0xFFFF = padding)
    v: jnp.ndarray  # (P,) int32 pixel row
    r: jnp.ndarray  # (P,) float32 accumulated red
    g: jnp.ndarray  # (P,) float32
    b: jnp.ndarray  # (P,) float32
    sample_count: jnp.ndarray  # (P,) int32
    path_length: jnp.ndarray  # (P,) int32


def make_worklist(width: int, height: int, padded_size: int | None = None) -> np.ndarray:
    """One record per pixel in row-major order, padded with dummy coords.

    Mirrors createWorkListForImage + padding (LoadBalancer.cpp:38-72).
    """
    n = width * height
    padded = n if padded_size is None else padded_size
    if padded < n:
        raise ValueError("padded_size smaller than pixel count")
    wl = np.zeros(padded, TRACE_RECORD_DTYPE)
    cols, rows = np.meshgrid(np.arange(width, dtype=np.uint16), np.arange(height, dtype=np.uint16))
    wl["u"][:n] = cols.ravel()
    wl["v"][:n] = rows.ravel()
    wl["u"][n:] = DUMMY_COORD
    wl["v"][n:] = DUMMY_COORD
    return wl


def to_device_batch(worklist: np.ndarray) -> WorkBatch:
    """Unpack a host worklist into device SoA arrays."""
    return WorkBatch(
        u=jnp.asarray(worklist["u"].astype(np.int32)),
        v=jnp.asarray(worklist["v"].astype(np.int32)),
        r=jnp.asarray(worklist["r"]),
        g=jnp.asarray(worklist["g"]),
        b=jnp.asarray(worklist["b"]),
        sample_count=jnp.asarray(worklist["sampleCount"].astype(np.int32)),
        path_length=jnp.asarray(worklist["pathLength"].astype(np.int32)),
    )


def from_device_batch(batch: WorkBatch) -> np.ndarray:
    """Pack device SoA results back into the 20-byte wire layout."""
    n = int(batch.u.shape[0])
    wl = np.zeros(n, TRACE_RECORD_DTYPE)
    wl["u"] = np.asarray(batch.u).astype(np.uint16)
    wl["v"] = np.asarray(batch.v).astype(np.uint16)
    wl["r"] = np.asarray(batch.r)
    wl["g"] = np.asarray(batch.g)
    wl["b"] = np.asarray(batch.b)
    wl["sampleCount"] = np.clip(np.asarray(batch.sample_count), 0, 0xFFFF).astype(np.uint16)
    wl["pathLength"] = np.asarray(batch.path_length).astype(np.uint16) # wraps mod 2^16 like the u16 field
    return wl


def raster_permutation(records: np.ndarray, width: int, height: int) -> np.ndarray:
    """(H*W,) int32 map: raster pixel index -> worklist record index.

    The worklist is shuffled (seed-142 parity shuffle) and padded with
    0xFFFF dummies, so reconstructing an image on device needs a gather
    by this permutation.  Every real pixel must appear exactly once
    (the LoadBalancer invariant: permutes, never duplicates).
    """
    assert records.dtype == TRACE_RECORD_DTYPE
    u = records["u"].astype(np.int64)
    v = records["v"].astype(np.int64)
    ok = (u < width) & (v < height)
    idx = v[ok] * width + u[ok]
    # Verify the invariant instead of trusting it: a worklist that
    # duplicates or drops a pixel (or a mismatched width/height) would
    # otherwise silently map missing pixels to record 0 in the preview.
    counts = np.bincount(idx, minlength=height * width)
    if not (counts == 1).all():
        raise ValueError(
            f"worklist is not a pixel permutation for {width}x{height}: "
            f"{int((counts == 0).sum())} missing, "
            f"{int((counts > 1).sum())} duplicated"
        )
    perm = np.zeros(height * width, np.int64)
    perm[idx] = np.nonzero(ok)[0]
    return perm.astype(np.int32)
