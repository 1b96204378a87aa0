"""ipu_path_trace_tpu: a physically based Monte-Carlo path tracer in JAX.

A from-scratch re-design of the Graphcore IPU path tracer
(reference: markp-gc/ipu_path_trace) using JAX / XLA.  The reference's
per-tile megakernel + byte-punned contribution stacks (reference:
src/codelets/codelets.cpp) are restructured into a wavefront renderer
over SoA ray batches with masked lanes, and the neural environment light
(NIF MLP) runs as large batched matmuls.

Layout:
  core/      vector math, camera, geometry, BSDFs, scene (pure jnp)
  cpu/       independent NumPy oracle used as the golden reference in tests
  render/    the jittable wavefront render step
  models/    neural image field (NIF): loaders, MLP, trainer, env lights
  parallel/  device-mesh sharding of the render step
  film/      HDR accumulation, tone mapping, PNG/EXR io
  runtime/   CLI, config, progressive render loop, worklists, AOT cache
  ui/        remote preview TCP server (packetcomms-parity protocol)
  utils/     logging and tracing helpers
"""

__version__ = "0.1.0"
