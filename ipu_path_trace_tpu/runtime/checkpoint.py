"""Mid-render checkpoint / resume (--checkpoint / --resume).

The reference can only restart a render from scratch (its UI restart
path, reference: src/PathTracerApp.cpp:652-686); an interrupted
100k-spp run loses everything, and a saved image cannot be continued
because the per-pixel sample sums are gone.  Here the progressive state
is small and explicit, so it checkpoints to one ``.npz`` and resumes
**bitwise identically**: step keys are ``fold_in(base_key, step)`` -
independent of render history - and accumulation order is preserved, so
an interrupted-and-resumed render produces the same EXR bytes as an
uninterrupted one (pinned by tests/test_checkpoint.py).

Saved state by mode:

  step-wise     ``film.hdr`` (the running sum over steps of per-step
                pixel means) as of the last completed step
  device-film   the device-resident SoA worklist sums (u, v, r, g, b,
                sample_count, path_length) - full int32 counts, never
                the clipping u16 wire field

A fingerprint of every numerics-affecting config field is stored with
the state; resuming under a different identity fails fast instead of
silently blending incompatible renders.

Load-balancing renders (--enable-load-balancing, step-wise mode only)
additionally save both double-buffer worklist LAYOUTS (the u,v record
order).  The seed-142 re-deal evolves the layout per step from
host-side path-length inspection with a two-buffer lag: at a checkpoint
after step N, the active buffer holds the layout step N+1 will upload
and the inactive buffer the layout for step N+2 (the re-deal that just
ran inside the same host task).  Restoring both buffers therefore
continues the re-deal chain bitwise-identically; later steps re-derive
their layouts from freshly rendered path lengths as usual.
"""

from __future__ import annotations

import json

import numpy as np

from ..utils.logging import logger

# Config fields that change the rendered values; a resume must match all
# of them for bit-identical continuation.  Presentation-only fields
# (exposure/gamma/outfile/save_interval/ui_port...) are deliberately
# absent - they may differ between the two halves of a run.
_FINGERPRINT_FIELDS = (
    "width", "height", "samples_per_step", "seed", "rng_impl",
    "assets", "scene", "max_path_length", "aa_noise_type",
    "aa_noise_scale", "fov", "stop_prob", "roulette_depth",
    "refractive_index", "env_map_rotation", "aperture", "focal_distance",
    "partials_type", "nif_mode", "device_film",
    "ipus", "mesh_shape", "enable_load_balancing", "layout",
    "sampler", "sobol_dims",
)

# Fields added after checkpoints already existed in the wild: a saved
# fingerprint that predates the field matches iff the current value is
# the behaviour those checkpoints actually had.
_FIELD_DEFAULTS = {"enable_load_balancing": False,
                   # Checkpoints that predate --layout were rendered with
                   # raster-ordered worklists (per-lane noise is
                   # position-keyed, so the layout is numerics-affecting):
                   "layout": "raster",
                   # Pre---sampler checkpoints were prng renders; the dim
                   # knob is inert there (normalised to None):
                   "sampler": "prng",
                   "sobol_dims": None}

_FORMAT = 1


def render_fingerprint(cfg, overrides: dict | None = None) -> dict:
    """Numerics identity of a render.  ``overrides`` substitutes live
    values for fields the remote UI can mutate away from cfg (fov,
    env_map_rotation, a hot-swapped assets dir) so the fingerprint
    records what actually lit the saved samples."""
    fp = {f: getattr(cfg, f) for f in _FINGERPRINT_FIELDS}
    if overrides:
        unknown = set(overrides) - set(_FINGERPRINT_FIELDS)
        if unknown:
            raise ValueError(f"unknown fingerprint fields: {unknown}")
        fp.update(overrides)
    if fp["sampler"] == "prng":
        fp["sobol_dims"] = None  # inert without --sampler sobol
    return fp


def save_checkpoint(path: str, cfg, step: int, *, hdr: np.ndarray | None = None,
                    soa: dict[str, np.ndarray] | None = None,
                    layouts: dict[str, np.ndarray] | None = None,
                    fingerprint_overrides: dict | None = None) -> None:
    """Write the progressive state at completed step ``step``.

    Exactly one of ``hdr`` (step-wise film sum) / ``soa`` (device-film
    worklist arrays) must be given.  ``layouts`` carries the
    load-balancer's double-buffer record order (module docstring) for
    --enable-load-balancing renders.  Atomic via write-then-rename so an
    interrupt mid-write never corrupts the previous checkpoint.
    """
    if (hdr is None) == (soa is None):
        raise ValueError("pass exactly one of hdr= or soa=")
    meta = {
        "format": _FORMAT,
        "step": int(step),
        "mode": "soa" if soa is not None else "hdr",
        "fingerprint": render_fingerprint(cfg, fingerprint_overrides),
    }
    arrays = {"meta": np.frombuffer(json.dumps(meta).encode(), np.uint8)}
    if hdr is not None:
        arrays["hdr"] = np.asarray(hdr, np.float32)
    else:
        for k, a in soa.items():
            arrays[f"soa_{k}"] = np.asarray(a)
    for k, a in (layouts or {}).items():
        arrays[f"layout_{k}"] = np.asarray(a)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    import os

    os.replace(tmp, path)
    logger().info("Checkpoint written at step %d -> '%s'", step, path)


def load_checkpoint(path: str, cfg) -> tuple[int, str, dict]:
    """Returns (completed_step, mode, state) after fingerprint validation.

    ``state`` is {"hdr": array} or the SoA dict, matching ``mode``.
    """
    try:
        z = np.load(path)
    except Exception as e:  # zipfile/pickle/OSError zoo -> one clear error
        raise ValueError(f"checkpoint '{path}' is unreadable: {e}") from e
    with z:
        try:
            meta = json.loads(bytes(z["meta"].tobytes()).decode())
        except Exception as e:
            raise ValueError(
                f"checkpoint '{path}' has no valid metadata: {e}") from e
        if meta.get("format") != _FORMAT:
            raise ValueError(
                f"checkpoint '{path}' has format {meta.get('format')}, "
                f"expected {_FORMAT}")
        want = render_fingerprint(cfg)
        got = meta["fingerprint"]
        diffs = {k: (got.get(k), want[k]) for k in want
                 if got.get(k, _FIELD_DEFAULTS.get(k)) != want[k]}
        if diffs:
            raise ValueError(
                "checkpoint does not match this render configuration "
                f"(checkpoint vs current): {diffs}")
        mode = meta["mode"]
        if mode == "hdr":
            state = {"hdr": z["hdr"]}
        else:
            state = {k[len("soa_"):]: z[k] for k in z.files
                     if k.startswith("soa_")}
        state["layouts"] = {k[len("layout_"):]: z[k] for k in z.files
                            if k.startswith("layout_")}
        return int(meta["step"]), mode, state
