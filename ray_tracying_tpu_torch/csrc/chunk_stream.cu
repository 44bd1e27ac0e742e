// Chunk-culled closest hit, closest hit with the winner's normal, and
// shadow any-hit for geom tables beyond a block's shared memory, for
// sm_90a.
//
// Replaces the TPU kernels kernels/chunk_stream.py::_closest_kernel,
// _closest_n_kernel and _occlusion_kernel of the JAX package; their plain
// PyTorch versions are kernels/chunk_stream.py::chunk_closest_plain,
// chunk_closest_n_plain and chunk_occlusion_plain of this package.
//
// Bound on an H100: operations.  A live ray runs the AABB tests of the
// chunks and the geom tests (about 80 f32 operations each) of the chunks it
// cannot rule out, against 8 rows of 4 bytes read and 1 to 5 rows written;
// where few lanes are live (the deep levels), bytes: every lane's act is
// read and its outputs written.
// Design (sweep.cuh): sweep_warp_kernel.  One cooperative launch lists the
// live lanes (dead ones get their outputs in the scan) and runs them on
// dense warps; the boxes are staged once a block; the cull is per warp (a
// ballot, no block barrier); rows arrive through a per-warp ring of bulk
// copies; the closest hits visit the nearest chunk first and merge by
// (t, row), chunk_closest_n computes the winner's normal once; the any-hit
// lane is done at its first blocker and the warp once no lane is open.
// The one-thread-per-lane sweep_kernel (the cull per thread, a chunk staged
// in shared memory when one thread of the block wants it) is reachable by
// name (the *_lane launchers) for the measurement that compares them; the
// package does not launch it.
// The table is the scene's Morton-ordered chunk table as it lies in
// memory, row-major (NC * chunk, 17); the sweeps stop at its last real
// row, so the all-zero padding rows are never run.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        --fmad=false -shared -Xcompiler -fPIC (kernels/_build.py).
// No fast-math: misses are true +inf, divisions and square roots are IEEE.

#include "sweep.cuh"

#ifdef __CUDACC__

namespace {

// The warp schedule of MODE, its counting build chosen at run time (work:
// count into work[0..2]).  Rows come through the per-warp ring of bulk
// copies, which needs a chunk of whole 16-byte copies and a 16-byte aligned
// table (the scenes' chunks of 256, fresh allocations): else the launch is
// refused with cudaErrorInvalidValue.
template <int MODE>
int launch_warp(const rtt::SweepParams& p, int* ctr, int* live, void* stream) {
  using namespace rtt;
  return p.work ? launch_sweep_warp(sweep_warp_kernel<MODE, true>, p, ctr, live, stream)
                : launch_sweep_warp(sweep_warp_kernel<MODE, false>, p, ctr, live, stream);
}

template <int MODE>
int launch_lane(const rtt::SweepParams& p, int threads, void* stream) {
  using namespace rtt;
  return p.work ? launch_sweep(sweep_kernel<MODE, true, true>, p, threads, stream)
                : launch_sweep(sweep_kernel<MODE, true, false>, p, threads, stream);
}

}  // namespace

// Plain C interface (loaded with ctypes).  Each launcher starts one sweep on
// `stream` without synchronizing and returns cudaGetLastError() (0 =
// launched).  work: three unsigned 64-bit ints to count into, or null.
// ctr: five ints of device memory, zero, that no other launch uses
// meanwhile (the kernel leaves them zero); live: R ints of scratch.

extern "C" int chunk_closest_launch(
    const float* rays, const float* boxes, const float* graze, const float* table,
    float* t, int* id, long long R, int G, int chunk, int motion,
    unsigned long long* work, int* ctr, int* live, void* stream) {
  const rtt::SweepParams p = rtt::make_sweep_params(
      rays, nullptr, boxes, graze, table, t, id, nullptr, nullptr, R, G, chunk, motion, work);
  return launch_warp<rtt::kSweepClosest>(p, ctr, live, stream);
}

extern "C" int chunk_closest_n_launch(
    const float* rays, const float* boxes, const float* graze, const float* table,
    float* t, int* id, float* n, long long R, int G, int chunk, int motion,
    unsigned long long* work, int* ctr, int* live, void* stream) {
  const rtt::SweepParams p = rtt::make_sweep_params(
      rays, nullptr, boxes, graze, table, t, id, n, nullptr, R, G, chunk, motion, work);
  return launch_warp<rtt::kSweepClosestN>(p, ctr, live, stream);
}

extern "C" int chunk_occlusion_launch(
    const float* rays, const float* maxt, const float* boxes, const float* graze,
    const float* table, uint8_t* blocked, long long R, int G, int chunk,
    unsigned long long* work, int* ctr, int* live, void* stream) {
  const rtt::SweepParams p = rtt::make_sweep_params(
      rays, maxt, boxes, graze, table, nullptr, nullptr, nullptr, blocked, R, G, chunk, 0,
      work);
  return launch_warp<rtt::kSweepAnyHit>(p, ctr, live, stream);
}

// The one-thread-per-lane schedule of the same three functions.
extern "C" int chunk_closest_lane_launch(
    const float* rays, const float* boxes, const float* graze, const float* table,
    float* t, int* id, long long R, int G, int chunk, int motion,
    unsigned long long* work, int threads, void* stream) {
  const rtt::SweepParams p = rtt::make_sweep_params(
      rays, nullptr, boxes, graze, table, t, id, nullptr, nullptr, R, G, chunk, motion, work);
  return launch_lane<rtt::kSweepClosest>(p, threads, stream);
}

extern "C" int chunk_closest_n_lane_launch(
    const float* rays, const float* boxes, const float* graze, const float* table,
    float* t, int* id, float* n, long long R, int G, int chunk, int motion,
    unsigned long long* work, int threads, void* stream) {
  const rtt::SweepParams p = rtt::make_sweep_params(
      rays, nullptr, boxes, graze, table, t, id, n, nullptr, R, G, chunk, motion, work);
  return launch_lane<rtt::kSweepClosestN>(p, threads, stream);
}

extern "C" int chunk_occlusion_lane_launch(
    const float* rays, const float* maxt, const float* boxes, const float* graze,
    const float* table, uint8_t* blocked, long long R, int G, int chunk,
    unsigned long long* work, int threads, void* stream) {
  const rtt::SweepParams p = rtt::make_sweep_params(
      rays, maxt, boxes, graze, table, nullptr, nullptr, nullptr, blocked, R, G, chunk, 0,
      work);
  return launch_lane<rtt::kSweepAnyHit>(p, threads, stream);
}

// What chunk_closest_launch (mode 0), chunk_closest_n_launch (mode 1) or
// chunk_occlusion_launch (mode 2) would launch for a table of G rows in
// chunks of `chunk`: out[0..4] = shared memory bytes, resident blocks per
// SM, SMs, threads per block, boxes staged (1) or read from global memory
// (0).
extern "C" int chunk_sweep_plan(int mode, int G, int chunk, int* out) {
  using namespace rtt;
  const int nc = (G + chunk - 1) / chunk;
  size_t bytes = 0;
  int per_sm = 0, sms = 0;
  int err;
  switch (mode) {
    case kSweepClosest:
      err = sweep_warp_plan(sweep_warp_kernel<kSweepClosest, false>, nc, chunk, bytes, per_sm,
                            sms);
      break;
    case kSweepClosestN:
      err = sweep_warp_plan(sweep_warp_kernel<kSweepClosestN, false>, nc, chunk, bytes, per_sm,
                            sms);
      break;
    default:
      err = sweep_warp_plan(sweep_warp_kernel<kSweepAnyHit, false>, nc, chunk, bytes, per_sm,
                            sms);
  }
  out[0] = (int)bytes; out[1] = per_sm; out[2] = sms; out[3] = kSweepThreads;
  out[4] = nc <= kStageChunks ? 1 : 0;
  return err;
}

#endif  // __CUDACC__
