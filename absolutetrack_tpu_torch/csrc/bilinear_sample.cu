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
// window to overflow and no planner: one launch for any N.
//
// It also carries the two other number formats of the shared body of
// those kernels, _tile_contrib (pallas_warp.py:143-192):
// * _tile_contrib's int8 row mix (pallas_warp.py:127-173, switched by
//   set_int8_window): for uint8 sources the two row weights quantize to
//   q = round(127 w), rounded half to even, the row mix is an exact int32
//   sum, and one multiply by 1/127 returns to f32 before the column mix.
// * _tile_contrib's bf16 row mix (pallas_warp.py:174-186, how every Pallas
//   kernel samples by default): the row weights 1 - wy and 1 - |1 - wy|
//   (the hat function's) and the four taps round to bf16 (f32 taps only:
//   uint8 and bf16 taps are exact in bf16), each bf16 x bf16
//   product is exact in f32, so each row's two terms sum with one f32
//   rounding, as the matrix unit's f32 accumulation of one nonzero pair
//   does; the column mix stays f32 (:188-192).
//
// What bounds it. Each output pixel moves 8 B of coordinates in and 4 B
// out (85 MB at the 768-slot lockstep chunk: the byte bound), and its
// four taps gather from the views, whose touched sectors (12 MB at the
// chunk) stay in the 50 MB L2. Measured on the H100 (scripts/k1_variants.py),
// layouts with one pixel a lane took time in proportion to the distinct
// 128-byte lines that a warp's gather touches, L1's line lookups: a warp
// of 32 pixels along a crop row walks down a source column, a line a
// lane, on the two views the rig rolls 90 degrees (2.1 lines a pixel over
// the chunk). So the lanes of one gather cover an 8 x 4 patch of the crop
// (0.85 lines a pixel, in either roll); the chunk then runs at 64% of its
// byte bound. At the sequential path's 4 x 9,216 pixels the launch is
// bound by latency.
//
// The design:
// * Grid (patches of a slot, slots): blockIdx.y is the slot, each warp of
//   a block one 8-wide patch of the slot's crop rows (row_px pixels wide,
//   from the caller's (N, H, W) planes; 8 for flat planes, which puts a
//   gather's lanes on 32 consecutive pixels). Indices inside a slot are
//   32-bit; the slot's 64-bit base and its view come from one warp-wide
//   broadcast load a slot, with no barrier (resolving the view once a
//   block through shared memory measured slower: its barrier holds every
//   warp), and no pixel divides. Beyond 65,535 slots the blocks stride
//   over slots.
// * Four pixels a thread, four rows apart (a warp patch 16 rows tall);
//   two (8 rows) on launches of fewer than 2^20 pixels, about one wave of
//   the card, where more, shorter threads spread over more SMs. Each
//   coordinate load and output store of a warp covers four whole 32-byte
//   sectors.
// * All taps of a thread are issued before any is combined, through the
//   read-only path. Coordinates and output take plain loads and stores:
//   streaming hints (__ldcs, __stcs) measured 1-2% slower at the chunk.
//
// Arithmetic follows absolutetrack_tpu/ops/resample.py:36-76 line for
// line: the in-bounds predicate of :60, the clamps of :61-62 and the tap
// combination of :70-75 in f32. The products and sums use the _rn
// intrinsics so that nvcc cannot contract them into FMAs: every operation
// rounds as in the plain PyTorch version (ops/warp_kernel.py). Built
// without --use_fast_math (no flush-to-zero).
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libk1.so bilinear_sample.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;    // warps a block
constexpr int kThreads = 32 * kWarps;
constexpr int kPatchW = 8;   // a gather's lanes: kPatchW x kPatchH pixels
constexpr int kPatchH = 4;
constexpr int kMaxPixels = 4;  // pixels a thread, kPatchH rows apart
constexpr int64_t kFewPixels = 1 << 20;  // launches below this take 2 pixels a thread
constexpr int kMaxGridY = 65535;
constexpr float kInv127 = 1.0f / 127.0f;  // f32(1/127), as the Pallas body's (1.0 / 127.0)
constexpr int kRowsF32 = 0, kRowsInt8 = 1, kRowsBf16 = 2;  // row-weight modes

// f32 rounded to bf16 (nearest even), back in f32
__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Source element types: the raw value a tap loads, its f32 value, and its
// value rounded to bf16 (exact for uint8 and bf16, so only f32 rounds).
struct U8 {
  using Raw = uint8_t;
  static __device__ __forceinline__ float value(Raw v) { return (float)v; }
  static __device__ __forceinline__ float bf16_value(Raw v) { return (float)v; }
};
struct F32 {
  using Raw = float;
  static __device__ __forceinline__ float value(Raw v) { return v; }
  static __device__ __forceinline__ float bf16_value(Raw v) { return bf16_round(v); }
};
struct BF16 {  // the bf16 bit pattern; its f32 value is exact
  using Raw = uint16_t;
  static __device__ __forceinline__ float value(Raw v) {
    return __uint_as_float((uint32_t)v << 16);
  }
  static __device__ __forceinline__ float bf16_value(Raw v) { return value(v); }
};

struct Args {
  const int64_t* image_idx;  // (N,)
  const float* xs;           // (N, P)
  const float* ys;           // (N, P)
  float* out;                // (N, P)
  int64_t view_stride;       // elements between views
  int64_t n;
  int n_views, row_stride, valid_h, valid_w, p;
  int row_px, patches_x;     // pixels in a crop row; patches across a row
};

template <typename S, int kRows, int kPixels>
__global__ void __launch_bounds__(kThreads)
bilinear_sample_kernel(const typename S::Raw* __restrict__ src, Args a) {
  using Raw = typename S::Raw;
  constexpr int kWarpRows = kPatchH * kPixels;  // a warp covers kPatchW x kWarpRows
  // this thread's pixels: column col of rows row0 + k * kPatchH of the
  // warp's patch (one division a thread, by the patches in a row)
  const int lane = threadIdx.x & 31;
  const int patch = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int patch_row = patch / a.patches_x;
  const int col = (patch - patch_row * a.patches_x) * kPatchW + (lane % kPatchW);
  const int first = (patch_row * kWarpRows + lane / kPatchW) * a.row_px + col;
  const bool in_row = col < a.row_px;

  for (int64_t slot = blockIdx.y; slot < a.n; slot += gridDim.y) {
    const int64_t base = slot * a.p;
    float x[kPixels], y[kPixels];
#pragma unroll
    for (int k = 0; k < kPixels; ++k) {
      const int i = first + k * kPatchH * a.row_px;
      const bool in = in_row && i < a.p;
      x[k] = in ? a.xs[base + i] : -1.f;
      y[k] = in ? a.ys[base + i] : -1.f;
    }
    // JAX's rule for the view index, as the plain version's view_index: a
    // negative index counts from the end once, then the gather clamps
    int64_t v = __ldg(a.image_idx + slot);  // one broadcast load a warp
    if (v < 0) v += a.n_views;
    v = v < 0 ? 0 : (v >= a.n_views ? a.n_views - 1 : v);
    const Raw* view = src + v * a.view_stride;

    // resample.py:60 in float: identical to the int32 form for |x| < 2^24,
    // and free of overflow beyond it; NaN coordinates fail `x >= 0`. The
    // clamps of :61-62 keep every tap inside the view, so the taps of an
    // invalid pixel are loaded too and masked after.
    float wx[kPixels], wy[kPixels];
    bool valid[kPixels];
    int offset[kPixels];
#pragma unroll
    for (int k = 0; k < kPixels; ++k) {
      const float x0 = floorf(x[k]);
      const float y0 = floorf(y[k]);
      wx[k] = x[k] - x0;
      wy[k] = y[k] - y0;
      valid[k] = (x[k] >= 0.f) && (x0 + 1.f <= (float)(a.valid_w - 1)) &&
                 (y[k] >= 0.f) && (y0 + 1.f <= (float)(a.valid_h - 1));
      const int x0c = min(max((int)x0, 0), a.valid_w - 2);
      const int y0c = min(max((int)y0, 0), a.valid_h - 2);
      offset[k] = y0c * a.row_stride + x0c;
    }
    Raw t00[kPixels], t01[kPixels], t10[kPixels], t11[kPixels];
#pragma unroll
    for (int k = 0; k < kPixels; ++k) {
      const Raw* row0 = view + offset[k];
      t00[k] = __ldg(row0);
      t01[k] = __ldg(row0 + 1);
      t10[k] = __ldg(row0 + a.row_stride);
      t11[k] = __ldg(row0 + a.row_stride + 1);
    }

#pragma unroll
    for (int k = 0; k < kPixels; ++k) {
      const float ax = __fsub_rn(1.f, wx[k]);
      const float ay = __fsub_rn(1.f, wy[k]);
      float acc;
      if constexpr (kRows == kRowsInt8) {
        // the int8 row mix: q = round(127 w), half to even; the int32
        // sums are exact (an invalid pixel's weights are masked below)
        const int q0 = __float2int_rn(__fmul_rn(ay, 127.f));
        const int q1 = __float2int_rn(__fmul_rn(wy[k], 127.f));
        const float c0 = __fmul_rn((float)(q0 * (int)t00[k] + q1 * (int)t10[k]), kInv127);
        const float c1 = __fmul_rn((float)(q0 * (int)t01[k] + q1 * (int)t11[k]), kInv127);
        acc = __fadd_rn(__fmul_rn(c0, ax), __fmul_rn(c1, wx[k]));
      } else if constexpr (kRows == kRowsBf16) {
        // the bf16 row mix. The second tap's hat weight is 1 - |1 - w|, as
        // the Pallas body forms it: not w where 1 - w rounds (coordinates
        // in [0, 1)). Products of bf16 values are exact in f32.
        const float r0 = bf16_round(ay), r1 = bf16_round(__fsub_rn(1.f, ay));
        const float g00 = S::bf16_value(t00[k]), g01 = S::bf16_value(t01[k]);
        const float g10 = S::bf16_value(t10[k]), g11 = S::bf16_value(t11[k]);
        const float c0 = __fadd_rn(__fmul_rn(r0, g00), __fmul_rn(r1, g10));
        const float c1 = __fadd_rn(__fmul_rn(r0, g01), __fmul_rn(r1, g11));
        acc = __fadd_rn(__fmul_rn(c0, ax), __fmul_rn(c1, __fsub_rn(1.f, ax)));
      } else {
        const float f00 = S::value(t00[k]), f01 = S::value(t01[k]);
        const float f10 = S::value(t10[k]), f11 = S::value(t11[k]);
        acc = __fmul_rn(__fmul_rn(f00, ax), ay);
        acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(f01, wx[k]), ay));
        acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(f10, ax), wy[k]));
        acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(f11, wx[k]), wy[k]));
      }
      const int i = first + k * kPatchH * a.row_px;
      if (in_row && i < a.p) a.out[base + i] = valid[k] ? acc : 0.f;
    }
  }
}

template <typename S, int kRows, int kPixels>
int launch_with(const void* src, const Args& a, cudaStream_t stream) {
  const int64_t rows = (a.p + a.row_px - 1) / a.row_px;
  const int64_t warp_rows = kPatchH * kPixels;
  const int64_t patches = (int64_t)a.patches_x * ((rows + warp_rows - 1) / warp_rows);
  const dim3 grid((unsigned)((patches + kWarps - 1) / kWarps),
                  (unsigned)(a.n < kMaxGridY ? a.n : kMaxGridY));
  bilinear_sample_kernel<S, kRows, kPixels><<<grid, kThreads, 0, stream>>>(
      static_cast<const typename S::Raw*>(src), a);
  return (int)cudaGetLastError();
}

template <typename S, int kRows>
int launch(const void* src, const Args& a, cudaStream_t stream) {
  return a.n * a.p < kFewPixels ? launch_with<S, kRows, 2>(src, a, stream)
                                : launch_with<S, kRows, kMaxPixels>(src, a, stream);
}

template <typename S>
int launch_rows(const void* src, int row_mode, const Args& a, cudaStream_t stream) {
  return row_mode == kRowsBf16 ? launch<S, kRowsBf16>(src, a, stream)
                               : launch<S, kRowsF32>(src, a, stream);
}

}  // namespace

// src_dtype: 0 = uint8, 1 = float32, 2 = bfloat16. row_mode: 0 = f32 row
// weights, 1 = int8 (uint8 only), 2 = bf16. row_px: the pixels of a crop
// row, the layout of each slot's P pixels (row-major); it changes the
// order in which K1 visits pixels, never a result.
// Returns the cudaError_t of the launch (0 on success), or 1000 for an
// unknown dtype, 1001 for int8 rows on a source that is not uint8, 1002
// for a shape outside 32-bit indices within a slot or a view, 1003 for an
// unknown row-weight mode.
extern "C" int k1_bilinear_sample(const void* src, int src_dtype, int row_mode,
                                  int row_px, const int64_t* image_idx,
                                  const float* xs, const float* ys, float* out,
                                  int n_views, int64_t view_stride,
                                  int row_stride, int valid_h, int valid_w,
                                  int64_t n, int64_t p, void* stream) {
  if (src_dtype < 0 || src_dtype > 2) return 1000;
  if (row_mode < kRowsF32 || row_mode > kRowsBf16) return 1003;
  if (row_mode == kRowsInt8 && src_dtype != 0) return 1001;
  // a block's last warps may sit up to kWarps patch rows past the slot
  if (row_px < 1 || p + (int64_t)(kWarps + 3) * kPatchH * kMaxPixels * row_px > INT32_MAX ||
      view_stride > INT32_MAX)
    return 1002;
  if (n == 0 || p == 0) return 0;
  const Args a{image_idx, xs, ys, out, view_stride, n,
               n_views, row_stride, valid_h, valid_w, (int)p,
               row_px, (row_px + kPatchW - 1) / kPatchW};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (src_dtype) {
    case 0:
      return row_mode == kRowsInt8 ? launch<U8, kRowsInt8>(src, a, s)
                                   : launch_rows<U8>(src, row_mode, a, s);
    case 1:
      return launch_rows<F32>(src, row_mode, a, s);
    default:
      return launch_rows<BF16>(src, row_mode, a, s);
  }
}
