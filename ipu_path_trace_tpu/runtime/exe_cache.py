"""Compiled-executable caching - the save-exe / load-exe analog.

The reference serialises the compiled Poplar executable plus a JSON
sidecar of program names so a minutes-long compile is paid once
(reference: src/ipu_utils.hpp:30-55,483-521).  The XLA analog has two
layers, both provided here:

  1. the JAX persistent compilation cache keyed on HLO (transparent
     reuse across processes), and
  2. explicit AOT serialisation via jax.export for named programs,
     stored as `<prefix>.<program>.bin` plus a `<prefix>.json` manifest -
     the ProgramManager-style registry (ipu_utils.hpp:186-256).
"""

from __future__ import annotations

import json
import os

import jax
from jax import export as jax_export

from ..utils.logging import logger


def _register_serializations() -> None:
    """Register our pytree NamedTuples for jax.export serialization."""
    from ..core.records import WorkBatch
    from ..core.scene import Scene
    from ..core.vecmath import Vec3
    from ..models.envlight import ConstantEnv, NifEnv, TextureEnv
    from ..models.nif import NifParams
    from ..render.params import RenderSettings

    for cls in (Scene, Vec3, WorkBatch, RenderSettings, ConstantEnv, TextureEnv, NifEnv, NifParams):
        try:
            jax_export.register_namedtuple_serialization(
                cls, serialized_name=f"ipu_path_trace_tpu.{cls.__name__}"
            )
        except ValueError:
            pass  # already registered


_register_serializations()


# The fixed default cache directory: <repo>/.jax_cache (listed in
# .gitignore).  The path is part of what a later process looks up, so it
# must not move between runs.
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache")


def compilation_cache_dir(cache_dir: str = "") -> str:
    """The persistent compilation cache's directory, by the one rule:
      1. ``JAX_COMPILATION_CACHE_DIR``, when set (``cache_dir`` is then
         ignored);
      2. otherwise ``cache_dir`` (--cache-dir), when given;
      3. otherwise DEFAULT_CACHE_DIR.
    """
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR") or cache_dir
            or DEFAULT_CACHE_DIR)


def enable_compilation_cache(cache_dir: str = "") -> str:
    """Turn on XLA's persistent compilation cache in
    compilation_cache_dir(cache_dir); returns that directory.

    Where JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and no
    other directory is set here.  Programs compiled for the CPU are not
    cached (returns ""): XLA:CPU ties its executables to the host's
    exact instruction-set features.
    """
    if jax.default_backend() == "cpu":
        return ""
    path = compilation_cache_dir(cache_dir)
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        if cache_dir and cache_dir != path:
            logger().info("--cache-dir '%s' ignored: JAX_COMPILATION_CACHE_DIR "
                          "is set to '%s'", cache_dir, path)
    else:
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    logger().info("Compilation cache enabled at '%s'", path)
    return path


class ProgramManager:
    """Named registry of jitted programs with AOT save/load.

    add() registers a program; save() exports every registered program's
    specialisation for its example args; load() rehydrates them so
    execution skips tracing and compilation entirely.
    """

    def __init__(self) -> None:
        self._programs: dict[str, jax.stages.Wrapped] = {}
        self._loaded: dict[str, object] = {}

    def add(self, name: str, fn) -> None:
        if name in self._programs:
            raise ValueError(f"Program '{name}' already registered.")
        self._programs[name] = fn

    def names(self) -> list[str]:
        return sorted(set(self._programs) | set(self._loaded))

    def has_loaded(self, name: str) -> bool:
        """True when ``name`` came from a deserialised executable (run()
        will call the AOT program, not JIT)."""
        return name in self._loaded

    def run(self, name: str, *args):
        if name in self._loaded:
            try:
                return self._loaded[name].call(*args)  # type: ignore[attr-defined]
            except (ValueError, TypeError) as e:
                # The AOT program is specialised to its export-time avals;
                # a runtime change (e.g. loading a NIF with a different
                # architecture over --load-exe) invalidates it.  Fall back
                # to JIT rather than killing the render.
                logger().warning(
                    "AOT program '%s' rejected its arguments (%s); "
                    "falling back to JIT compilation.", name, e,
                )
                del self._loaded[name]
        return self._programs[name](*args)

    def save(self, prefix: str, example_args: dict[str, tuple]) -> None:
        """Export each program specialised to its example args.

        example_args maps program name -> args tuple.  Mirrors saveExe +
        ProgramManager::serialise (ipu_utils.hpp:38-45,232-239).
        """
        manifest = {}
        for name, args in example_args.items():
            fn = self._programs[name]
            try:
                exported = jax_export.export(fn)(*args)
                blob = exported.serialize()
            except Exception as e:
                # The user explicitly asked for a saved executable; a
                # silent partial manifest would masquerade as success and
                # --load-exe would quietly recompile (ipu_utils.hpp:38-45
                # fails loudly here too).
                raise RuntimeError(f"Could not export program '{name}'") from e
            path = f"{prefix}.{name}.bin"
            with open(path, "wb") as f:
                f.write(blob)
            manifest[name] = os.path.basename(path)
            logger().info("Saved executable: %s (%d bytes)", path, len(blob))
        with open(f"{prefix}.json", "w") as f:
            json.dump({"programs": manifest}, f, indent=2)

    def load(self, prefix: str) -> bool:
        """Load previously exported programs (loadExe, ipu_utils.hpp:47-55)."""
        manifest_path = f"{prefix}.json"
        if not os.path.exists(manifest_path):
            logger().error("No executable manifest at '%s'", manifest_path)
            return False
        with open(manifest_path) as f:
            manifest = json.load(f)["programs"]
        if not manifest:
            logger().error("Executable manifest '%s' lists no programs", manifest_path)
            return False
        base = os.path.dirname(prefix)
        for name, fname in manifest.items():
            with open(os.path.join(base, fname) if base else fname, "rb") as f:
                blob = f.read()
            self._loaded[name] = jax_export.deserialize(blob)
            logger().info("Loaded executable for program '%s'", name)
        return True
