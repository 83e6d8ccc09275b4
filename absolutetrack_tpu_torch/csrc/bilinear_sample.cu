// K1: bilinear sampling of crop pixels from the source views.
//
// Replaces the Pallas kernels of absolutetrack_tpu/ops/pallas_warp.py:
// _fused_warp_kernel (:224), _narrow_warp_kernel (:195),
// _overflow_warp_kernel (:281), _banded_warp_kernel (:307) and
// _covering_warp_kernel (:322). All five compute one function -- the
// bilinear sample of (N, P) source coordinates from (V, H, W) views, 0
// where any tap falls outside the source -- and differ only in how they
// tile the source into VMEM windows, because Mosaic has no vector gather.
// The TPU runs the overflow kernel as a second pass over the few tiles
// that miss pass A's window, merged per tile, on calls of >= 2048 tiles
// (the 768-slot lockstep chunk), and cuts calls above 768 slots into
// slabs to keep its scalar memory small. Hopper gathers, so K1 has no
// window to overflow, no tiling and no planner: one thread per output
// pixel, one launch for any N (the grid is (N * P + 255) / 256 blocks of
// 256 threads with 64-bit pixel indices: 27,648 blocks at N = 768,
// 36,864 at N = 1,024).
//
// What bounds it: bytes. Each output pixel moves 8 B of coordinates in
// and 4 B out; the taps are gathers from the views, which at the main
// path's four uint8 views (1.2 MB) sit in the 50 MB L2. At the main
// path's 4 x 9,216 pixels that is ~0.45 MB of coordinate and output
// traffic, well under a microsecond at 3.35 TB/s, so one call is
// launch-bound. At the 24-recording lockstep chunk (768 x 9,216 pixels)
// the coordinates and output alone are ~85 MB and the 768 views 252 MB,
// of which the taps touch only the crops' footprints: there the launch
// is bound by bytes. Coordinate reads and output writes are coalesced.
//
// Arithmetic follows absolutetrack_tpu/ops/resample.py:36-76 line for
// line: the in-bounds predicate of :60, the clamps of :61-62 and the tap
// combination of :70-75 in f32. The products and sums use the _rn
// intrinsics so that nvcc cannot contract them into FMAs: every operation
// rounds as in the plain PyTorch version. Built without --use_fast_math
// (no flush-to-zero).
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libk1.so bilinear_sample.cu

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float load_tap(const uint8_t* p) { return (float)(*p); }
__device__ __forceinline__ float load_tap(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_tap(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename T>
__global__ void bilinear_sample_kernel(
    const T* __restrict__ src,            // (V, src_rows, row_stride)
    const int64_t* __restrict__ image_idx,  // (N,)
    const float* __restrict__ xs,         // (N, P)
    const float* __restrict__ ys,         // (N, P)
    float* __restrict__ out,              // (N, P)
    int n_views, int64_t view_stride, int row_stride,
    int valid_h, int valid_w, int64_t n, int64_t p) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n * p) return;
  const int64_t slot = i / p;

  const float x = xs[i];
  const float y = ys[i];
  const float x0 = floorf(x);
  const float y0 = floorf(y);
  const float wx = x - x0;
  const float wy = y - y0;
  // resample.py:60 in float: identical to the int32 form for |x| < 2^24,
  // and free of overflow beyond it; NaN coordinates fail `x >= 0`
  const bool valid = (x >= 0.f) && (x0 + 1.f <= (float)(valid_w - 1)) &&
                     (y >= 0.f) && (y0 + 1.f <= (float)(valid_h - 1));
  if (!valid) {
    out[i] = 0.f;
    return;
  }
  // resample.py:61-62 (inside the valid region they are no-ops)
  const int x0c = min(max((int)x0, 0), valid_w - 2);
  const int y0c = min(max((int)y0, 0), valid_h - 2);

  // JAX's rule for the view index, as the plain version's view_index: a
  // negative index counts from the end once, then the gather clamps
  int64_t v = image_idx[slot];
  if (v < 0) v += n_views;
  v = v < 0 ? 0 : (v >= n_views ? n_views - 1 : v);
  const T* row0 = src + v * view_stride + (int64_t)y0c * row_stride + x0c;
  const T* row1 = row0 + row_stride;
  const float f00 = load_tap(row0);
  const float f01 = load_tap(row0 + 1);
  const float f10 = load_tap(row1);
  const float f11 = load_tap(row1 + 1);

  const float ax = __fsub_rn(1.f, wx);
  const float ay = __fsub_rn(1.f, wy);
  float acc = __fmul_rn(__fmul_rn(f00, ax), ay);
  acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(f01, wx), ay));
  acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(f10, ax), wy));
  acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(f11, wx), wy));
  out[i] = acc;
}

constexpr int kThreads = 256;

template <typename T>
int launch(const void* src, const int64_t* image_idx, const float* xs,
           const float* ys, float* out, int n_views, int64_t view_stride,
           int row_stride, int valid_h, int valid_w, int64_t n, int64_t p,
           cudaStream_t stream) {
  const int64_t total = n * p;
  if (total == 0) return 0;
  const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
  bilinear_sample_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(src), image_idx, xs, ys, out, n_views, view_stride,
      row_stride, valid_h, valid_w, n, p);
  return (int)cudaGetLastError();
}

}  // namespace

// src_dtype: 0 = uint8, 1 = float32, 2 = bfloat16.
// Returns the cudaError_t of the launch (0 on success); 1000 for an
// unknown dtype code.
extern "C" int k1_bilinear_sample(const void* src, int src_dtype,
                                  const int64_t* image_idx, const float* xs,
                                  const float* ys, float* out, int n_views,
                                  int64_t view_stride, int row_stride,
                                  int valid_h, int valid_w, int64_t n,
                                  int64_t p, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (src_dtype) {
    case 0:
      return launch<uint8_t>(src, image_idx, xs, ys, out, n_views, view_stride,
                             row_stride, valid_h, valid_w, n, p, s);
    case 1:
      return launch<float>(src, image_idx, xs, ys, out, n_views, view_stride,
                           row_stride, valid_h, valid_w, n, p, s);
    case 2:
      return launch<__nv_bfloat16>(src, image_idx, xs, ys, out, n_views,
                                   view_stride, row_stride, valid_h, valid_w,
                                   n, p, s);
    default:
      return 1000;
  }
}
