"""Convert a keras SavedModel directory to a loadable NIF assets dir.

Parity tool for the reference's ``src/keras/model_to_hdf5.py:22-25``,
which loads a keras saved-model directory (the format the reference's
published NIF models ship in - e.g.
``nif_models/urban_alley_01_4k_fp16_yuv/``) and re-saves it as the
``converted.hdf5`` the renderer ingests.  The reference leans on
TensorFlow for both halves; this environment has no TensorFlow, so the
checkpoint is read directly:

  * ``variables/variables.index`` is a LevelDB-format SSTable (the
    TensorFlow TensorBundle metadata file: block-based table, varint
    block handles, 48-byte footer with magic 0xdb4775248b80fb57,
    prefix-compressed keys with restart arrays, optional snappy block
    compression) whose values are BundleEntryProto messages
    (dtype/shape/shard/offset/size), decoded here with a minimal
    protobuf wire reader;
  * ``variables/variables.data-NNNNN-of-MMMMM`` shards hold the raw
    little-endian tensor bytes at the recorded offsets.

Dense kernels/biases are recognised from the object-graph checkpoint
keys (``layer_with_weights-N/kernel/.ATTRIBUTES/VARIABLE_VALUE``; the
TF1-style ``dense_N/kernel`` fallback is also accepted), ordered by N,
and written through NifWeights.save_h5 into the keras-H5 layout
``NifWeights.load_h5`` / the reference's Hdf5Model.cpp read.  Layer
activations are not stored in checkpoints (they live in the
saved_model.pb graph); the NIF contract fixes them - relu on hidden
layers, linear output (NifModel.cpp:326) - and make_params re-validates
at load.  Data CRCs are not verified (crc32c is not in the stdlib); a
corrupt checkpoint surfaces as a shape-chain error instead.

Usage:
    python -m ipu_path_trace_tpu.models.convert <saved_model_dir> <out_dir>

Writes <out_dir>/converted.hdf5 (and its converted.npz twin) and copies nif_metadata.txt from the
saved-model's assets.extra/ (the reference's layout) when present, so
<out_dir> is directly loadable via load_nif_assets / --assets.
"""

from __future__ import annotations

import os
import re
import shutil
import struct
import sys

import numpy as np

from ..utils.logging import logger
from .nif import NifLayer, NifWeights, save_weights

_TABLE_MAGIC = 0xDB4775248B80FB57

# TensorFlow DataType enum -> numpy dtype (types.proto); only the types
# a keras Dense checkpoint can plausibly hold.
_DTYPES = {
    1: np.float32,   # DT_FLOAT
    2: np.float64,   # DT_DOUBLE
    3: np.int32,     # DT_INT32
    9: np.int64,     # DT_INT64
    14: None,        # DT_BFLOAT16 (no stable numpy dtype; widened below)
    19: np.float16,  # DT_HALF
}


# --------------------------------------------------------------------------
# protobuf wire-format primitives
# --------------------------------------------------------------------------


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 63:
            raise ValueError("varint too long")


def _iter_fields(buf: bytes):
    """Yield (field_number, wire_type, value) over a protobuf message.

    Wire types: 0 varint -> int, 1 fixed64 -> bytes, 2 length-delimited
    -> bytes, 5 fixed32 -> bytes.  Groups (3/4) are rejected.
    """
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wt = tag >> 3, tag & 7
        if wt == 0:
            val, pos = _read_varint(buf, pos)
        elif wt == 1:
            val, pos = buf[pos:pos + 8], pos + 8
        elif wt == 2:
            n, pos = _read_varint(buf, pos)
            val, pos = buf[pos:pos + n], pos + n
        elif wt == 5:
            val, pos = buf[pos:pos + 4], pos + 4
        else:
            raise ValueError(f"unsupported wire type {wt}")
        yield field, wt, val


def _parse_shape(buf: bytes) -> tuple[int, ...]:
    """TensorShapeProto -> dim sizes (field 2 = repeated Dim{1: size})."""
    dims = []
    for field, _, val in _iter_fields(buf):
        if field == 2:
            size = 0
            for f2, _, v2 in _iter_fields(val):
                if f2 == 1:
                    size = v2
            dims.append(size)
    return tuple(dims)


def _parse_bundle_entry(buf: bytes) -> dict:
    """BundleEntryProto: 1 dtype, 2 shape, 3 shard_id, 4 offset, 5 size."""
    entry = {"dtype": 0, "shape": (), "shard_id": 0, "offset": 0, "size": 0}
    for field, _, val in _iter_fields(buf):
        if field == 1:
            entry["dtype"] = val
        elif field == 2:
            entry["shape"] = _parse_shape(val)
        elif field == 3:
            entry["shard_id"] = val
        elif field == 4:
            entry["offset"] = val
        elif field == 5:
            entry["size"] = val
    return entry


# --------------------------------------------------------------------------
# snappy block decompression (format: github.com/google/snappy)
# --------------------------------------------------------------------------


def _snappy_decompress(buf: bytes) -> bytes:
    total, pos = _read_varint(buf, 0)
    out = bytearray()
    while pos < len(buf):
        tag = buf[pos]
        pos += 1
        kind = tag & 3
        if kind == 0:  # literal
            n = tag >> 2
            if n >= 60:
                extra = n - 59
                n = int.from_bytes(buf[pos:pos + extra], "little")
                pos += extra
            n += 1
            out += buf[pos:pos + n]
            pos += n
            continue
        if kind == 1:  # copy, 1-byte offset
            length = ((tag >> 2) & 0x7) + 4
            offset = ((tag >> 5) << 8) | buf[pos]
            pos += 1
        elif kind == 2:  # copy, 2-byte offset
            length = (tag >> 2) + 1
            offset = int.from_bytes(buf[pos:pos + 2], "little")
            pos += 2
        else:  # copy, 4-byte offset
            length = (tag >> 2) + 1
            offset = int.from_bytes(buf[pos:pos + 4], "little")
            pos += 4
        if offset == 0:
            raise ValueError("corrupt snappy stream (zero offset)")
        for _ in range(length):  # ranges may overlap: byte-wise copy
            out.append(out[-offset])
    if len(out) != total:
        raise ValueError(f"snappy length mismatch: {len(out)} != {total}")
    return bytes(out)


# --------------------------------------------------------------------------
# LevelDB-format table reader (TensorBundle .index files)
# --------------------------------------------------------------------------


def _read_block(data: bytes, offset: int, size: int) -> bytes:
    """Fetch a block given its handle; trailer = 1-byte type + crc32."""
    block = data[offset:offset + size]
    ctype = data[offset + size]
    if ctype == 0:
        return block
    if ctype == 1:
        return _snappy_decompress(block)
    raise ValueError(f"unsupported block compression type {ctype}")


def _iter_block_entries(block: bytes):
    """Yield (key, value) from a table block (prefix-compressed entries;
    the restart array occupies the last 4*(n+1) bytes)."""
    n_restarts = struct.unpack_from("<I", block, len(block) - 4)[0]
    end = len(block) - 4 * (n_restarts + 1)
    pos = 0
    key = b""
    while pos < end:
        shared, pos = _read_varint(block, pos)
        non_shared, pos = _read_varint(block, pos)
        value_len, pos = _read_varint(block, pos)
        key = key[:shared] + block[pos:pos + non_shared]
        pos += non_shared
        value = block[pos:pos + value_len]
        pos += value_len
        yield key, value


def read_tensor_bundle(index_path: str) -> dict[str, dict]:
    """Parse a TensorBundle .index file -> {tensor_name: bundle entry}."""
    with open(index_path, "rb") as f:
        data = f.read()
    if len(data) < 48:
        raise ValueError(f"'{index_path}' too short to be a bundle index")
    magic = struct.unpack_from("<Q", data, len(data) - 8)[0]
    if magic != _TABLE_MAGIC:
        raise ValueError(
            f"'{index_path}' is not a LevelDB-format table "
            f"(magic {magic:#x} != {_TABLE_MAGIC:#x})")
    footer = data[len(data) - 48:]
    _, p = _read_varint(footer, 0)       # metaindex offset
    _, p = _read_varint(footer, p)       # metaindex size
    idx_off, p = _read_varint(footer, p)
    idx_size, p = _read_varint(footer, p)
    index_block = _read_block(data, idx_off, idx_size)

    entries: dict[str, dict] = {}
    for _, handle in _iter_block_entries(index_block):
        off, p2 = _read_varint(handle, 0)
        size, _ = _read_varint(handle, p2)
        for key, value in _iter_block_entries(_read_block(data, off, size)):
            if key == b"":  # BundleHeaderProto
                continue
            entries[key.decode("utf-8")] = _parse_bundle_entry(value)
    return entries


def load_checkpoint_tensor(variables_prefix: str, entry: dict) -> np.ndarray:
    """Read one tensor's raw bytes from its data shard."""
    # Shard count is recoverable from any shard filename; single-shard
    # checkpoints (every published NIF) use -00000-of-00001.
    dirname = os.path.dirname(variables_prefix)
    base = os.path.basename(variables_prefix)
    shards = sorted(
        f for f in os.listdir(dirname)
        if f.startswith(base + ".data-") and "-of-" in f
    )
    if not shards:
        raise FileNotFoundError(f"no data shards for '{variables_prefix}'")
    n_shards = int(shards[0].rsplit("-of-", 1)[1])
    shard_path = os.path.join(
        dirname, f"{base}.data-{entry['shard_id']:05d}-of-{n_shards:05d}")
    np_dtype = _DTYPES.get(entry["dtype"])
    with open(shard_path, "rb") as f:
        f.seek(entry["offset"])
        raw = f.read(entry["size"])
    if entry["dtype"] == 14:  # bfloat16: widen via int32 bit-shift
        u16 = np.frombuffer(raw, np.uint16)
        arr = (u16.astype(np.uint32) << 16).view(np.float32).astype(np.float32)
    elif np_dtype is None:
        raise ValueError(f"unsupported checkpoint dtype {entry['dtype']}")
    else:
        arr = np.frombuffer(raw, np_dtype)
    return arr.reshape(entry["shape"])


# --------------------------------------------------------------------------
# keras SavedModel -> NifWeights
# --------------------------------------------------------------------------

_OBJ_KEY = re.compile(
    r"^layer_with_weights-(\d+)/(kernel|bias)/\.ATTRIBUTES/VARIABLE_VALUE$")
_TF1_KEY = re.compile(r"^(?:.*/)?dense(?:_(\d+))?/(kernel|bias)$")


def saved_model_to_weights(model_dir: str) -> NifWeights:
    """Read a keras SavedModel directory's Dense stack as NifWeights."""
    prefix = os.path.join(model_dir, "variables", "variables")
    index_path = prefix + ".index"
    if not os.path.exists(index_path):
        raise FileNotFoundError(
            f"'{model_dir}' has no variables/variables.index - not a "
            "keras saved-model directory")
    entries = read_tensor_bundle(index_path)

    by_layer: dict[int, dict[str, np.ndarray]] = {}
    for key, entry in entries.items():
        m = _OBJ_KEY.match(key) or _TF1_KEY.match(key)
        if not m:
            continue
        idx = int(m.group(1) or 0)
        by_layer.setdefault(idx, {})[m.group(2)] = load_checkpoint_tensor(
            prefix, entry)
    if not by_layer:
        raise ValueError(
            f"no Dense kernel/bias variables found in '{index_path}' "
            f"({len(entries)} checkpoint entries)")

    layers: list[NifLayer] = []
    prev_out: int | None = None
    for n, idx in enumerate(sorted(by_layer)):
        tensors = by_layer[idx]
        if "kernel" not in tensors:
            raise ValueError(f"layer_with_weights-{idx} has no kernel")
        kernel = tensors["kernel"]
        if kernel.ndim != 2:
            raise ValueError(
                f"layer_with_weights-{idx} kernel has rank {kernel.ndim}; "
                "only Dense layers are supported (Hdf5Model.cpp:39-52)")
        if prev_out is not None and kernel.shape[0] < prev_out:
            # Layer inputs may only grow (the skip-concat) - a shrink
            # means the ordering or the checkpoint is wrong:
            raise ValueError(
                f"layer {idx} input {kernel.shape[0]} < previous output "
                f"{prev_out}: not a NIF-shaped Dense chain")
        prev_out = kernel.shape[1]
        is_last = n == len(by_layer) - 1
        layers.append(NifLayer(
            name=f"dense_{idx}" if idx else "dense",
            kernel=kernel.astype(np.float32),
            bias=tensors.get("bias", None),
            activation="none" if is_last else "relu",
            dtype="float16" if kernel.dtype == np.float16 else "float32",
        ))
    return NifWeights(layers)


def convert(model_dir: str, out_dir: str) -> str:
    """SavedModel dir -> assets dir with converted.hdf5 (+ metadata)."""
    weights = saved_model_to_weights(model_dir)
    os.makedirs(out_dir, exist_ok=True)
    save_weights(out_dir, weights)
    h5_path = os.path.join(out_dir, "converted.hdf5")
    for l in weights.layers:
        logger().info("  %-10s kernel %s bias %s %s %s", l.name,
                      l.kernel.shape,
                      None if l.bias is None else l.bias.shape,
                      l.activation, l.dtype)
    meta_src = os.path.join(model_dir, "assets.extra", "nif_metadata.txt")
    if os.path.exists(meta_src):
        shutil.copy(meta_src, os.path.join(out_dir, "nif_metadata.txt"))
        logger().info("Copied nif_metadata.txt from assets.extra/")
    else:
        logger().warning(
            "No assets.extra/nif_metadata.txt next to the model; copy the "
            "metadata in before pointing --assets at '%s'", out_dir)
    logger().info("Wrote %s", h5_path)
    return h5_path


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 2:
        print("usage: python -m ipu_path_trace_tpu.models.convert "
              "<saved_model_dir> <out_dir>", file=sys.stderr)
        return 2
    convert(argv[0], argv[1])
    return 0


if __name__ == "__main__":
    sys.exit(main())
