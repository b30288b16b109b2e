"""rust_raytrace_tpu — a GPU ray tracing framework in JAX.

A from-scratch JAX/XLA rebuild of the capabilities of the reference
Rust/CUDA ray tracer `gerikkub/rust_raytrace` (read-only checkout expected at
$RUST_RAYTRACE_REF, default /root/reference).  The compute path is a wavefront
renderer: camera rays are generated as SoA batches, traced front to back
through triangle pages by one GPU kernel (a Pallas kernel on the Triton
route) with a running min-hit reduction, and secondary (bounce) rays are
re-dispatched as new wavefronts with active-ray compaction — the structural
template is the reference's CUDA workqueue backend
(cuda_raytrace_lib/src/cuda_raytrace.rs:277-515), not its recursive CPU path.

Layout:
  math3d / geometry / materials / obj_parser / camera / scene / octree
      host-side scene pipeline (numpy f32, optional C++ native fast path)
  ops/        traversal: numpy contract model, brute-force XLA, the GPU
              trace kernel and its plain-XLA version, culling, compaction
  engine      the production renderer (one jitted program per render)
  render      the brute-force reference wavefront and the shared shading
  parallel/   multi-device image-tile data parallelism (Mesh + shard_map)
  models/     scene families (teapot presets, circles, multi-object)
  utils/      png writer, progress/stats, per-ray differential debugger
  oracle      slow recursive numpy reference renderer (differential oracle)
"""

__version__ = "0.1.0"
