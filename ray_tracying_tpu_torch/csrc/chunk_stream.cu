// Chunk-culled closest hit, closest hit with the winner's normal, and
// shadow any-hit for geom tables beyond a block's shared memory, for
// sm_90a.
//
// Replaces the TPU kernels kernels/chunk_stream.py::_closest_kernel,
// _closest_n_kernel and _occlusion_kernel of the JAX package; their plain
// PyTorch versions are kernels/chunk_stream.py::chunk_closest_plain,
// chunk_closest_n_plain and chunk_occlusion_plain of this package.
//
// Bound on an H100: operations.  A live ray runs one AABB test per chunk
// and the geom tests (about 80 f32 operations each) of the chunks it
// cannot rule out, against 8 rows of 4 bytes read and 1 to 5 rows written.
// Design (sweep.cuh): one thread per ray, the running winner in registers
// across the sweep, the cull per thread, the staging of a chunk in shared
// memory culled per block, the any-hit thread done at its first blocker.
// The table is the scene's Morton-ordered chunk table as it lies in
// memory, row-major (NC * chunk, 17); the sweep stops at its last real
// row, so the all-zero padding rows are never read.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        --fmad=false -shared -Xcompiler -fPIC (kernels/_build.py).
// No fast-math: misses are true +inf, divisions and square roots are IEEE.

#include "sweep.cuh"

#ifdef __CUDACC__

// Plain C interface (loaded with ctypes).
extern "C" int chunk_closest_launch(
    const float* rays, const float* boxes, const float* graze, const float* table,
    float* t, int* id,
    long long R, int G, int chunk, int motion, int threads, void* stream) {
  const rtt::SweepParams p = rtt::make_sweep_params(
      rays, nullptr, boxes, graze, table, t, id, nullptr, nullptr, R, G, chunk, motion);
  return rtt::launch_sweep(rtt::sweep_kernel<rtt::kSweepClosest, true>, p,
                           threads, stream);
}

extern "C" int chunk_closest_n_launch(
    const float* rays, const float* boxes, const float* graze, const float* table,
    float* t, int* id,
    float* n, long long R, int G, int chunk, int motion, int threads,
    void* stream) {
  const rtt::SweepParams p = rtt::make_sweep_params(
      rays, nullptr, boxes, graze, table, t, id, n, nullptr, R, G, chunk, motion);
  return rtt::launch_sweep(rtt::sweep_kernel<rtt::kSweepClosestN, true>, p,
                           threads, stream);
}

extern "C" int chunk_occlusion_launch(
    const float* rays, const float* maxt, const float* boxes, const float* graze,
    const float* table, uint8_t* blocked, long long R, int G, int chunk, int threads, void* stream) {
  const rtt::SweepParams p = rtt::make_sweep_params(
      rays, maxt, boxes, graze, table, nullptr, nullptr, nullptr, blocked, R, G, chunk, 0);
  return rtt::launch_sweep(rtt::sweep_kernel<rtt::kSweepAnyHit, true>, p,
                           threads, stream);
}

#endif  // __CUDACC__
