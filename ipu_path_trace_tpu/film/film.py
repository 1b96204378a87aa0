"""HDR film accumulation and tone mapping.

Equivalent of AccumulatedImage
(reference: src/AccumulatedImage.cpp).  The film is RGB float32 (the
reference stores BGR because of OpenCV; we keep RGB and convert at the
image writers).  Accumulation semantics match exactly:

  hdr[v, u] += rgb / sampleCount        per step  (AccumulatedImage.cpp:59-74)
  save: hdr / step                                (AccumulatedImage.cpp:48-56)
  tone map: (x * 2^exposure)^(1/gamma) -> 8 bit   (AccumulatedImage.cpp:23-46)

If the native host runtime (csrc/) is built, the OpenMP C++ kernels are
used; otherwise vectorised NumPy fallbacks run (same math).
"""

from __future__ import annotations

import numpy as np

from ..core.records import TRACE_RECORD_DTYPE


def tone_map(hdr: np.ndarray, step: int, exposure: float, gamma: float) -> np.ndarray:
    """HDR (H, W, 3) float32 -> LDR uint8, reference tone-map math."""
    from ..runtime import native

    scaled = hdr * (1.0 / max(step, 1))
    out = native.tonemap(scaled, exposure, gamma)
    if out is not None:
        return out
    exposure_scale = 2.0**exposure
    inv_gamma = 1.0 / gamma
    with np.errstate(invalid="ignore"):
        ldr = np.power(np.maximum(scaled * exposure_scale, 0.0), inv_gamma)
    # Round to nearest like the reference's cv::convertTo saturate_cast:
    return np.clip(np.rint(ldr * 255.0), 0.0, 255.0).astype(np.uint8)


class Film:
    """Progressive HDR accumulator over render steps."""

    def __init__(self, width: int, height: int):
        self.width = width
        self.height = height
        self.hdr = np.zeros((height, width, 3), np.float32)

    def reset(self) -> None:
        self.hdr[:] = 0.0

    def accumulate(self, records: np.ndarray) -> None:
        """Add one step's worth of trace records into the film.

        records: structured TRACE_RECORD_DTYPE array.  Padding entries
        (u/v out of range, 0xFFFF markers) are skipped; each record adds
        rgb / sampleCount (AccumulatedImage.cpp:59-74).
        """
        assert records.dtype == TRACE_RECORD_DTYPE
        from ..runtime import native

        if native.accumulate(records, self.hdr):
            return
        u = records["u"].astype(np.int64)
        v = records["v"].astype(np.int64)
        ok = (u < self.width) & (v < self.height) & (records["sampleCount"] > 0)
        scale = np.zeros(len(records), np.float32)
        np.divide(1.0, records["sampleCount"], out=scale, where=records["sampleCount"] > 0)
        rgb = np.stack([records["r"], records["g"], records["b"]], axis=-1) * scale[:, None]
        # Scatter-add. NOTE: records are one-per-pixel by construction
        # (load balancing permutes, never duplicates - worklist.py), an
        # invariant the native OpenMP path (csrc/pt_host.cpp:46-48) relies
        # on to skip atomics; np.add.at tolerates duplicates regardless.
        np.add.at(self.hdr, (v[ok], u[ok]), rgb[ok])

    def accumulate_soa(
        self,
        u: np.ndarray,
        v: np.ndarray,
        r: np.ndarray,
        g: np.ndarray,
        b: np.ndarray,
        sample_count: np.ndarray,
    ) -> None:
        """Accumulate directly from SoA arrays with int32 sample counts.

        The device-film fetch path must NOT round-trip through the
        20-byte wire record: its u16 sampleCount field clips at 65535,
        while a device-resident film accumulates counts for the whole
        render (the canonical 100k-spp run reaches ~100000
        samples/record), which would scale the saved image ~1.5x too
        bright.  Same math as accumulate(), full-width counts.  Uses
        the OpenMP C++ kernel when built (csrc/pt_host.cpp
        pt_accumulate_soa), NumPy fallback otherwise.
        """
        from ..runtime import native

        if native.accumulate_soa(u, v, r, g, b, sample_count, self.hdr):
            return
        u = np.asarray(u).astype(np.int64)
        v = np.asarray(v).astype(np.int64)
        cnt = np.asarray(sample_count).astype(np.int64)
        # Mirror the C++ kernel's bounds exactly (incl. negatives, which
        # would otherwise wrap via int64 indexing in np.add.at):
        ok = (u >= 0) & (u < self.width) & (v >= 0) & (v < self.height) & (cnt > 0)
        scale = np.zeros(len(u), np.float32)
        np.divide(1.0, cnt, out=scale, where=cnt > 0)
        rgb = (
            np.stack([np.asarray(r), np.asarray(g), np.asarray(b)], axis=-1)
            * scale[:, None]
        )
        np.add.at(self.hdr, (v[ok], u[ok]), rgb[ok])

    def hdr_at_step(self, step: int) -> np.ndarray:
        """The physically-normalised HDR image: accumulated / step."""
        return self.hdr * (1.0 / max(step, 1))

    def ldr(self, step: int, exposure: float, gamma: float) -> np.ndarray:
        return tone_map(self.hdr, step, exposure, gamma)
