"""Array/sharding introspection logging.

The debug-level analog of the reference's logTensorInfo
(reference: src/io_utils.hpp:50-63), which dumps each tensor's shape,
dtype and on-device layout.  Here the interesting extra is the
jax.sharding: which mesh axes each array spans and how many bytes live
per device.
"""

from __future__ import annotations

import jax
import numpy as np

from .logging import logger


def _leaf_info(path: str, leaf) -> str | None:
    if not hasattr(leaf, "shape") or not hasattr(leaf, "dtype"):
        return None
    nbytes = int(np.prod(leaf.shape, dtype=np.int64)) * leaf.dtype.itemsize
    sharding = getattr(leaf, "sharding", None)
    if sharding is not None:
        try:
            spec = getattr(sharding, "spec", None)
            n_dev = len(sharding.device_set)
            shard_desc = f" sharding={spec if spec is not None else sharding} devices={n_dev}"
            # Per-device bytes from the actual shard shape - dividing by
            # the device count is wrong for arrays sharded on only one
            # axis of a multi-axis mesh (the other axis replicates):
            shard_shape = sharding.shard_shape(tuple(leaf.shape))
            nbytes = int(np.prod(shard_shape, dtype=np.int64)) * leaf.dtype.itemsize
        except Exception:  # noqa: BLE001 - best-effort debug output
            shard_desc = ""
    else:
        shard_desc = ""
    return (f"{path}: shape={tuple(leaf.shape)} dtype={leaf.dtype} "
            f"bytes/device={nbytes}{shard_desc}")


def log_tensor_info(name: str, tree) -> None:
    """Debug-log shape/dtype/sharding of every array leaf in a pytree."""
    log = logger()
    if not log.isEnabledFor(10):  # DEBUG
        return
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    for path, leaf in leaves:
        desc = _leaf_info(f"{name}{jax.tree_util.keystr(path)}", leaf)
        if desc:
            log.debug("Tensor info: %s", desc)
