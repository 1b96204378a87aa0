"""Neural Image Field (NIF): metadata, weights, and inference.

Re-implementation of the reference's NIF stack:
  - metadata JSON parser          (reference: src/neural_networks/NifMetaData.cpp:19-64)
  - keras HDF5 weight loader      (reference: src/keras/Hdf5Model.cpp:21-133)
  - Fourier-feature encoder + dense MLP + tone-map decoder
                                  (reference: src/neural_networks/NifModel.cpp:185-245,299-326)

The encoder/decoder math is kept exactly: uv' = 2*(uv - 1), features
[sin(u 2^j), sin(v 2^j), cos(u 2^j), cos(v 2^j)] for j < embedding_dim,
hidden layers with auto-detected skip-concat of the input features, and
decode y = x * max + mean (with eps folded into mean), exp() when
log-tone-mapped.  Matmuls run in bfloat16 with float32 accumulation
(the analog of fp16 weights + half partials, PathTracerApp.cpp:140-145).

Weights: keras HDF5 (``converted.hdf5``) is the interchange format that
the reference and models/convert.py write.  Each shipped asset also
keeps the same weights as ``converted.npz``, which the loader prefers,
so rendering needs no HDF5 library (regenerate with
``python scripts/export_npz.py assets/<dir> ...``).
"""

from __future__ import annotations

import json
import dataclasses
import os
from typing import Any, NamedTuple, Sequence

import numpy as np
import jax
import jax.numpy as jnp


# --------------------------------------------------------------------------
# Metadata (nif_metadata.txt)
# --------------------------------------------------------------------------


@dataclasses.dataclass
class NifMetaData:
    """Parsed nif_metadata.txt (schema of NifMetaData.cpp:19-64)."""

    embedding_dimension: int
    name: str
    image_shape: tuple[int, ...]
    eps: float
    log_tone_map: bool
    max: float
    mean: np.ndarray  # (3,) float32, eps already folded in when log-tone-mapped
    hidden_size: int

    @staticmethod
    def load(path: str) -> "NifMetaData":
        with open(path) as f:
            pt = json.load(f)
        enc = pt["encode_params"]
        mean = np.asarray(enc["mean"], np.float32).copy()
        eps = float(enc["eps"])
        log_tone_map = bool(enc["log_tone_map"])
        if log_tone_map:
            # Fold the inverse eps into the mean (NifMetaData.cpp:49-53):
            mean -= eps
        # Scrape hidden size from the recorded train command
        # (NifMetaData.cpp:56-64):
        hidden = 0
        cmd = pt.get("train_command", [])
        for i, tok in enumerate(cmd):
            if tok == "--layer-size" and i + 1 < len(cmd):
                hidden = int(cmd[i + 1])
        return NifMetaData(
            embedding_dimension=int(pt["embedding_dimension"]),
            name=str(pt.get("name", "")),
            image_shape=tuple(int(x) for x in pt["original_image_shape"]),
            eps=eps,
            log_tone_map=log_tone_map,
            max=float(enc["max"]),
            mean=mean,
            hidden_size=hidden,
        )

    def save(self, path: str, train_command: Sequence[str] = ()) -> None:
        mean = self.mean.copy()
        if self.log_tone_map:
            mean += self.eps  # un-fold for the on-disk schema
        doc = {
            "embedding_dimension": self.embedding_dimension,
            "encode_params": {
                "eps": self.eps,
                "log_tone_map": self.log_tone_map,
                "max": self.max,
                "mean": [float(x) for x in mean],
                "transfer_function": "log" if self.log_tone_map else "linear",
            },
            "name": self.name,
            "original_image_shape": list(self.image_shape),
            "train_command": list(train_command)
            or ["train_nif.py", "--layer-size", str(self.hidden_size)],
        }
        with open(path, "w") as f:
            json.dump(doc, f, indent=2)


# --------------------------------------------------------------------------
# Weights (keras HDF5)
# --------------------------------------------------------------------------


@dataclasses.dataclass
class NifLayer:
    name: str
    kernel: np.ndarray  # (in, out)
    bias: np.ndarray | None
    activation: str  # "relu" | "linear"/"none"
    dtype: str  # "float16" | "float32"


@dataclasses.dataclass
class NifWeights:
    """Host-side model description (shared across chip replicas)."""

    layers: list[NifLayer]

    @staticmethod
    def load_h5(path: str) -> "NifWeights":
        """Load a keras-saved .h5 (layout of Hdf5Model.cpp:72-81).

        Only Dense layers are supported; InputLayer/Concatenate entries in
        the config are skipped (the skip-concat is re-detected from layer
        shapes at inference time), any other layer class is an error -
        mirroring the reference loader (Hdf5Model.cpp:39-52).
        """
        try:
            import h5py
        except ImportError as e:
            raise ImportError(
                f"reading '{path}' needs h5py; without it, load the asset's "
                "converted.npz instead (write one with "
                "scripts/export_npz.py where h5py is installed)") from e

        layers: list[NifLayer] = []
        with h5py.File(path, "r") as f:
            cfg = f.attrs["model_config"]
            if isinstance(cfg, bytes):
                cfg = cfg.decode("utf-8")
            model = json.loads(cfg)
            for entry in model["config"]["layers"]:
                cls = entry["class_name"]
                if cls in ("InputLayer", "Concatenate"):
                    continue
                if cls != "Dense":
                    raise ValueError(f"Layer class '{cls}' not supported by NIF loader.")
                lcfg = entry["config"]
                name = lcfg["name"]
                kernel = np.asarray(f[f"/model_weights/{name}/{name}/kernel:0"])
                bias = None
                if lcfg.get("use_bias", True):
                    bias = np.asarray(f[f"/model_weights/{name}/{name}/bias:0"])
                layers.append(
                    NifLayer(
                        name=name,
                        kernel=kernel,
                        bias=bias,
                        activation="none" if lcfg.get("activation", "linear") == "linear" else lcfg["activation"],
                        dtype=str(lcfg.get("dtype", "float32")),
                    )
                )
        if not layers:
            raise ValueError(f"No Dense layers found in '{path}'.")
        return NifWeights(layers)

    def save_npz(self, path: str) -> None:
        """Save as NumPy .npz: arrays ``kernel_i`` / ``bias_i`` in the
        layer's storage dtype (as save_h5 stores them) plus the layer
        descriptions as a JSON string (no pickling)."""
        desc = [{"name": l.name, "activation": l.activation, "dtype": l.dtype,
                 "use_bias": l.bias is not None} for l in self.layers]
        arrays = {"layers": np.asarray(json.dumps(desc))}
        for i, l in enumerate(self.layers):
            store_dtype = np.float16 if l.dtype == "float16" else np.float32
            arrays[f"kernel_{i}"] = l.kernel.astype(store_dtype)
            if l.bias is not None:
                arrays[f"bias_{i}"] = l.bias.astype(store_dtype)
        np.savez(path, **arrays)

    @staticmethod
    def load_npz(path: str) -> "NifWeights":
        """Load weights written by save_npz (bit-identical arrays)."""
        with np.load(path, allow_pickle=False) as f:
            desc = json.loads(str(f["layers"]))
            layers = [
                NifLayer(
                    name=d["name"],
                    kernel=f[f"kernel_{i}"],
                    bias=f[f"bias_{i}"] if d["use_bias"] else None,
                    activation=d["activation"],
                    dtype=d["dtype"],
                )
                for i, d in enumerate(desc)
            ]
        if not layers:
            raise ValueError(f"No Dense layers found in '{path}'.")
        return NifWeights(layers)

    def save_h5(self, path: str) -> None:
        """Save in the same keras-style layout the loader reads."""
        import h5py

        layer_cfgs = [
            {
                "class_name": "Dense",
                "config": {
                    "name": l.name,
                    "units": int(l.kernel.shape[1]),
                    "activation": "linear" if l.activation in ("none", "linear") else l.activation,
                    "use_bias": l.bias is not None,
                    "dtype": l.dtype,
                },
            }
            for l in self.layers
        ]
        model_config = {"class_name": "Functional", "config": {"layers": layer_cfgs}}
        with h5py.File(path, "w") as f:
            f.attrs["model_config"] = json.dumps(model_config)
            f.attrs["keras_version"] = "ipu_path_trace_tpu"
            f.attrs["backend"] = "jax"
            for l in self.layers:
                g = f.create_group(f"/model_weights/{l.name}/{l.name}")
                store_dtype = np.float16 if l.dtype == "float16" else np.float32
                g.create_dataset("kernel:0", data=l.kernel.astype(store_dtype))
                if l.bias is not None:
                    g.create_dataset("bias:0", data=l.bias.astype(store_dtype))


# --------------------------------------------------------------------------
# Device params + inference
# --------------------------------------------------------------------------


class NifParams(NamedTuple):
    """Pytree of device arrays for NIF inference.

    kernels/biases are stored in the compute dtype (bfloat16 by default -
    the analog of the reference's fp16 weights); decode runs in
    float32 (NifModel.cpp:221-245 "Always do output decoding at fp32").
    """

    kernels: tuple  # ((in, out) arrays)
    biases: tuple  # ((out,) arrays; may contain None-like zeros)
    max: Any  # () float32
    mean: Any  # (3,) float32
    log_tone_map: Any  # () bool_

    @property
    def embedding_dim(self) -> int:
        # First layer input is the 4*E fourier features (NifModel.cpp:216).
        return self.kernels[0].shape[0] // 4


def make_params(
    weights: NifWeights, meta: NifMetaData, dtype=jnp.bfloat16
) -> NifParams:
    # The inference paths hard-code relu on hidden layers and identity on
    # the output (like the reference network shape, NifModel.cpp:326);
    # reject anything else at load time rather than silently mis-shading:
    for i, l in enumerate(weights.layers):
        is_last = i == len(weights.layers) - 1
        allowed = ("none", "linear", "") if is_last else ("relu",)
        if (l.activation or "none") not in allowed:
            raise ValueError(
                f"Unsupported activation '{l.activation}' on layer "
                f"{l.name!r} (hidden layers must be relu; output linear)"
            )
    kernels = tuple(jnp.asarray(l.kernel.astype(np.float32), dtype) for l in weights.layers)
    biases = tuple(
        jnp.asarray((l.bias if l.bias is not None else np.zeros(l.kernel.shape[1])).astype(np.float32), dtype)
        for l in weights.layers
    )
    return NifParams(
        kernels=kernels,
        biases=biases,
        max=jnp.float32(meta.max),
        mean=jnp.asarray(meta.mean, jnp.float32),
        log_tone_map=jnp.asarray(meta.log_tone_map),
    )


def save_weights(asset_dir: str, weights: NifWeights) -> None:
    """Write an asset's weights in both formats: converted.hdf5 (the
    interchange format) and converted.npz (what the loader prefers)."""
    weights.save_h5(os.path.join(asset_dir, "converted.hdf5"))
    weights.save_npz(os.path.join(asset_dir, "converted.npz"))


def load_nif_assets(asset_dir: str, dtype=jnp.bfloat16) -> tuple[NifParams, NifMetaData, NifWeights]:
    """Load an 'assets.extra'-style directory: nif_metadata.txt plus
    converted.npz, or converted.hdf5 where no .npz exists (a directory
    from the reference).

    Mirrors PathTracerApp::loadNifModels (PathTracerApp.cpp:106-123).
    """
    meta = NifMetaData.load(os.path.join(asset_dir, "nif_metadata.txt"))
    npz = os.path.join(asset_dir, "converted.npz")
    if os.path.exists(npz):
        weights = NifWeights.load_npz(npz)
    else:
        weights = NifWeights.load_h5(os.path.join(asset_dir, "converted.hdf5"))
    return make_params(weights, meta, dtype), meta, weights


def fourier_features(u: jnp.ndarray, v: jnp.ndarray, embedding_dim: int) -> jnp.ndarray:
    """Positional encoding (NifModel.cpp:185-218 / host twin :417-432).

    uv' = 2 * (uv - 1); features layout [sin(u c_j) | sin(v c_j) |
    cos(u c_j) | cos(v c_j)] with c_j = 2^j, j < embedding_dim.
    """
    coeffs = jnp.asarray(2.0 ** np.arange(embedding_dim), u.dtype)  # (E,)
    uu = 2.0 * (u - 1.0)
    vv = 2.0 * (v - 1.0)
    pos_u = uu[..., None] * coeffs  # (P, E)
    pos_v = vv[..., None] * coeffs
    return jnp.concatenate(
        [jnp.sin(pos_u), jnp.sin(pos_v), jnp.cos(pos_u), jnp.cos(pos_v)], axis=-1
    )


# 3-term Cody-Waite split of 2*pi: _P1 + _P2 + _P3 == 2*pi exactly in
# double, _P1/_P2 carry few mantissa bits so k*_P1 / k*_P2 are exact in
# f32 for the k <= ~2^11 this encode produces (E <= 16).
_P1 = 6.28125
_P2 = 0.0019352436065673828
_P3 = 6.357301884918343e-08
_INV_2PI = 0.15915494309189535
_SEED_STRIDE = 4  # re-seed the double-angle recurrence every 4 octaves


def _sincos_reduced(x, j: int):
    """Exact-seeded sin/cos of 2^j * x: the f32 angle is exact (power-of
    -two scale of an exact operand), Cody-Waite reduces it into
    [-pi, pi] with no precision loss, and the transcendentals run on
    the reduced residue."""
    theta = x * float(2 ** j)
    k = jnp.round(theta * _INV_2PI)
    r = ((theta - k * _P1) - k * _P2) - k * _P3
    return jnp.sin(r), jnp.cos(r)


def nif_encode(u, v, embedding_dim: int, compute_dtype):
    """Feature-major Fourier features -> (4E, B), the int8 chain's
    encode (models/quant.py).

    Same rows as fourier_features ([sin(u 2^j) | sin(v 2^j) |
    cos(u 2^j) | cos(v 2^j)] of uv' = 2(uv - 1)), built by a re-seeded
    double-angle recurrence: octaves j = 0, 4, 8, ... are evaluated
    exactly via _sincos_reduced, the octaves in between by
    sin 2x = 2 sin x cos x, cos 2x = 1 - 2 sin^2 x.  The recurrence
    alone would drift ~2^j ulps (the doubling map is chaotic); the
    re-seeding bounds the error at ~2^(_SEED_STRIDE-1) ulp.
    """
    uu = 2.0 * (u - 1.0)  # (B,) - exact: u in [0,1], Sterbenz + *2
    vv = 2.0 * (v - 1.0)

    def octaves(x):
        ss, cc = [], []
        for j in range(embedding_dim):
            if j % _SEED_STRIDE == 0:
                s, c = _sincos_reduced(x, j)
            else:
                s, c = ss[-1], cc[-1]
                s, c = 2.0 * s * c, 1.0 - 2.0 * s * s
            ss.append(s)
            cc.append(c)
        return ss, cc

    sus, cus = octaves(uu)
    svs, cvs = octaves(vv)
    return jnp.stack(sus + svs + cus + cvs, axis=0).astype(compute_dtype)


def nif_apply(params: NifParams, u: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """Run NIF inference for a batch of (u, v) coords -> (P, 3) float32.

    One big batched matmul chain; skip-concat of the input
    features is auto-detected from layer shapes exactly like the
    reference (NifModel.cpp:303-309).  Output is in the network's native
    channel order (callers reverse for RGB, codelets.cpp:377-378).
    """
    compute_dtype = params.kernels[0].dtype
    feats = fourier_features(u, v, params.embedding_dim).astype(compute_dtype)
    x = feats
    for i, (w, b) in enumerate(zip(params.kernels, params.biases)):
        if x.shape[-1] != w.shape[0]:
            x = jnp.concatenate([x, feats], axis=-1)
        x = jnp.dot(x, w, preferred_element_type=jnp.float32) + b.astype(jnp.float32)
        is_last = i == len(params.kernels) - 1
        if not is_last:
            x = jnp.maximum(x, 0.0).astype(compute_dtype)
    y = x.astype(jnp.float32) * params.max + params.mean
    return jnp.where(params.log_tone_map, jnp.exp(y), y)


def analyse_nif(weights: NifWeights, sample_count: int) -> dict:
    """FLOPs / parameter report (NifModel::analyseModel, NifModel.cpp:122-144).

    ``flops`` counts useful (model) multiply-adds plus bias adds.
    """
    flops = 0
    param_bytes = 0
    for l in weights.layers:
        itemsize = 2 if l.dtype == "float16" else 4
        param_bytes += l.kernel.size * itemsize
        fan_in, fan_out = l.kernel.shape
        layer_flops = 2 * fan_in * fan_out
        if l.bias is not None:
            param_bytes += l.bias.size * itemsize
            layer_flops += l.bias.shape[0]
        flops += layer_flops
    return {
        "layers": len(weights.layers),
        "hidden_size": weights.layers[0].kernel.shape[1],
        "batch_size": sample_count,
        "flops": flops * sample_count,
        "parameters_kib": param_bytes / 1024.0,
    }


def make_synthetic_nif(
    key: jax.Array | int = 0,
    embedding_dim: int = 12,
    hidden: int | Sequence[int] = 320,
    num_hidden: int = 6,
    skip_layer: int | None = 3,
    out_channels: int = 3,
    dtype_name: str = "float16",
) -> tuple[NifWeights, NifMetaData]:
    """Random NIF with the canonical architecture (6 x 320, embed 12).

    Used for benchmarking and tests when no trained assets are available
    (the reference ships metadata but not weights).  skip_layer inserts a
    hidden layer whose input width is hidden + 4*embedding_dim so the
    skip-concat code path is exercised.  ``hidden`` may be a per-layer
    width list (mixed-width nets; every inference path re-detects the
    skip from layer shapes, so variable widths need no other support).
    """
    if isinstance(key, int):
        key = jax.random.key(key)
    widths = [hidden] * num_hidden if isinstance(hidden, int) else list(hidden)
    if len(widths) != num_hidden:
        raise ValueError(f"need {num_hidden} widths, got {widths}")
    in_dim = 4 * embedding_dim
    dims: list[tuple[int, int]] = []
    cur = in_dim
    for i in range(num_hidden):
        inw = cur + in_dim if (skip_layer is not None and i == skip_layer) else cur
        dims.append((inw, widths[i]))
        cur = widths[i]
    dims.append((cur, out_channels))
    layers = []
    for i, (fan_in, fan_out) in enumerate(dims):
        key, k1, k2 = jax.random.split(key, 3)
        scale = np.sqrt(2.0 / fan_in)
        kern = np.asarray(jax.random.normal(k1, (fan_in, fan_out))) * scale
        bias = np.asarray(jax.random.normal(k2, (fan_out,))) * 0.01
        is_last = i == len(dims) - 1
        layers.append(
            NifLayer(
                name=f"dense_{i}",
                kernel=kern.astype(np.float32),
                bias=bias.astype(np.float32),
                activation="none" if is_last else "relu",
                dtype=dtype_name,
            )
        )
    meta = NifMetaData(
        embedding_dimension=embedding_dim,
        name="synthetic",
        image_shape=(2048, 4096, 3),
        eps=1e-8,
        log_tone_map=True,
        max=3.43,
        mean=np.asarray([-2.35, -2.27, -1.96], np.float32) - 1e-8,
        hidden_size=widths[0],
    )
    return NifWeights(layers), meta
