"""Guard the shipped NIF assets: loadable, right architecture, sane env.

The bench default (assets/nif_w192e16) and the other shipped widths are
binary artifacts; this pins that they load through the reference-format
parsers, carry the architecture their name claims, and decode to a
physically sane sky (positive HDR radiance)."""

import os

import numpy as np
import jax.numpy as jnp
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ASSETS = {
    "procedural_sky_nif": ([320] * 6, 12),  # canonical reference architecture
    "nif_w128": ([128] * 6, 12),
    "nif_w192": ([192] * 6, 12),
    # E=16 puts the skip-concat exactly on 256 input features:
    "nif_w192e16": ([192] * 6, 16),
    # Quality asset (the widest E=16 net):
    "nif_w256e16": ([256] * 6, 16),
    # The mixed-width net (per-layer widths):
    "nif_m128-128-80-128-128-128": ([128, 128, 80, 128, 128, 128], 12),
    # Reference-scale asset: canonical 6x320 trained on the deterministic
    # 2048x4096 synthetic urban-alley env (the reference's
    # urban_alley_01_4k content class):
    "urban_alley_synth_nif": ([320] * 6, 12),
}


@pytest.mark.parametrize("name,hidden,embed", sorted(
    (k, *v) for k, v in ASSETS.items()
))
def test_shipped_nif_asset(name, hidden, embed):
    from ipu_path_trace_tpu.models.nif import analyse_nif, load_nif_assets, nif_apply

    params, meta, weights = load_nif_assets(
        os.path.join(REPO, "assets", name), jnp.bfloat16
    )
    info = analyse_nif(weights, 1)
    assert info["layers"] == len(hidden) + 1  # hidden + output
    assert meta.embedding_dimension == embed
    # Exact per-layer architecture (the name IS the claim), including the
    # skip-concat at layer len//2 (the reference's width autodetect):
    out_dims = [l.kernel.shape[1] for l in weights.layers[:-1]]
    assert out_dims == hidden, out_dims
    in_dims = [l.kernel.shape[0] for l in weights.layers]
    skip = len(hidden) // 2
    assert in_dims[skip] == hidden[skip - 1] + 4 * meta.embedding_dimension
    # Decodes to positive HDR radiance over a UV probe grid:
    u = jnp.linspace(0.05, 0.95, 64)
    v = jnp.linspace(0.05, 0.95, 64)
    out = np.asarray(nif_apply(params, u, v))
    assert np.isfinite(out).all()
    assert out.min() > 0.0  # log-tone-mapped skies decode through exp()
    assert out.max() < 1e5


@pytest.mark.parametrize("name", sorted(set(ASSETS) - {"procedural_sky_nif"}))
def test_train_command_is_replayable(name):
    """The recorded train_command must parse through the real trainer CLI
    and describe the shipped architecture (the r2-era canonical asset
    keeps its historical command and is exempt)."""
    import json

    meta = json.load(open(os.path.join(REPO, "assets", name,
                                       "nif_metadata.txt")))
    cmd = meta["train_command"]
    assert cmd[:3] == ["python", "-m", "ipu_path_trace_tpu.models.train_nif"]
    argv = cmd[3:]

    # Parse through the REAL trainer CLI (models/train_nif.build_parser):
    from ipu_path_trace_tpu.models.train_nif import build_parser

    src_parser = build_parser()
    args = src_parser.parse_args(argv)
    # Training sources are either the shipped EXR or a deterministic
    # synth: spec (models/synth_env.py) - both fully replayable:
    assert (args.input.endswith("procedural_sky.exr")
            or args.input.startswith("synth:"))
    assert args.embedding_dimension == ASSETS[name][1]
    sizes = ([int(t) for t in args.layer_sizes.split(",")]
             if args.layer_sizes else [args.layer_size] * args.layer_count)
    assert sizes == ASSETS[name][0]
    assert args.epochs == 6000 and args.cosine_decay
