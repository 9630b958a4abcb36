// Tiled triangle rasterizer for Hopper (sm_90a): coverage, 1/z test and
// flat shading of pre-binned faces.
//
// Replaces the Pallas TPU kernel `_raster_kernel` in
// maniskill_tpu/render/pallas_rasterizer.py (called by
// `pallas_rasterize_tiles`). The vertex stage and the per-band binning stay
// plain torch in maniskill_tpu_torch/render/tiled_rasterizer.py; this file is
// only the per-pixel loop.
//
// Inputs
//   table  (B, F, 16) f32  per-face records
//          [e01 a,b,c, e12 a,b,c, e20 a,b,c, 1/z a,b,c, seg, r, g, b]
//   idx    (B, T, K) i32   per 16-row band, the overlapping face ids in
//                          list order (stable); the wrapper passes K = F,
//                          so no band's list is ever cut
//   counts (B, T)    i32   live entries of each band's list; a block walks
//                          all of them, however many, staging at most
//                          kChunk records at a time
// Outputs
//   iz  (B, H, W)    f32   winning 1/z (0 = background)
//   seg (B, H, W)    i32   winning segmentation id (-1 = background)
//   rgb (B, H, W, 3) f32   winning flat colour
//
// Semantics (identical to the TPU kernel): for every pixel, walk the band's
// face list in order; a face covers the pixel when all three edge planes are
// >= 0; it wins when its 1/z is strictly greater than the best so far (which
// starts at 0), so the first face in list order wins a tie. Each plane is
// evaluated as (a*px + b*py) + c with explicitly rounded multiplies and adds
// (__fmul_rn/__fadd_rn), so FMA contraction cannot move edge pixels and the
// result matches the plain torch version bit for bit.
//
// What bounds it: the coverage tests, B*H*W*n_band_faces of them at ~20 FP32
// operations each; the face records are read once per block (64 bytes a
// face) and reused by all 2048 pixels of the block, so device-memory bytes
// are small against the ALU work. The design therefore keeps each pixel's
// state in registers (a thread owns 8 rows of one column), hoists the
// per-column products out of the row loop, and streams the band's records
// through shared memory in chunks of 256 faces (16 KB), where every thread
// reads the same record at once (a broadcast, no bank conflicts). A whole
// per-env table would not fit: 4096 faces x 64 B = 256 KB > 227 KB a block
// may use. Blocks are (env, band, 128-column chunk); ragged rows and columns
// are masked at the store, so H and W need not be multiples of 16 or 128.

#include <cuda_runtime.h>
#include <climits>

namespace {

constexpr int kTileH = 16;
constexpr int kCols = 128;
constexpr int kThreads = 256;
constexpr int kRows = kTileH * kCols / kThreads;  // rows per thread: 8
constexpr int kChunk = 256;                       // records staged per pass

__device__ __forceinline__ float plane(float a_px, float b, float py, float c) {
  return __fadd_rn(__fadd_rn(a_px, __fmul_rn(b, py)), c);
}

__global__ void __launch_bounds__(kThreads)
raster_tiles_kernel(const float* __restrict__ table,
                    const int* __restrict__ idx,
                    const int* __restrict__ counts,
                    float* __restrict__ iz_out,
                    int* __restrict__ seg_out,
                    float* __restrict__ rgb_out,
                    int F, int T, int K, int H, int W, int n_col_chunks) {
  __shared__ float4 recs[kChunk * 4];

  const int cc = blockIdx.x % n_col_chunks;
  const int bt = blockIdx.x / n_col_chunks;  // env * T + band
  const int b = bt / T;
  const int t = bt % T;
  const int col = cc * kCols + (threadIdx.x % kCols);
  const int row0 = t * kTileH + (threadIdx.x / kCols) * kRows;

  const float px = static_cast<float>(col) + 0.5f;
  float py[kRows], iz[kRows], r[kRows], g[kRows], bl[kRows];
  int sg[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    py[i] = static_cast<float>(row0 + i) + 0.5f;
    iz[i] = 0.f;
    sg[i] = -1;
    r[i] = g[i] = bl[i] = 0.f;
  }

  const int n = counts[bt];
  const int* list = idx + static_cast<size_t>(bt) * K;
  const float4* tab = reinterpret_cast<const float4*>(table) + static_cast<size_t>(b) * F * 4;

  for (int base = 0; base < n; base += kChunk) {
    const int m = min(kChunk, n - base);
    for (int i = threadIdx.x; i < m * 4; i += kThreads) {
      recs[i] = tab[static_cast<size_t>(list[base + i / 4]) * 4 + (i % 4)];
    }
    __syncthreads();
    for (int j = 0; j < m; ++j) {
      const float4 q0 = recs[4 * j + 0];  // a01 b01 c01 a12
      const float4 q1 = recs[4 * j + 1];  // b12 c12 a20 b20
      const float4 q2 = recs[4 * j + 2];  // c20 za  zb  zc
      const float4 q3 = recs[4 * j + 3];  // seg r   g   b
      const float a01 = __fmul_rn(q0.x, px);
      const float a12 = __fmul_rn(q0.w, px);
      const float a20 = __fmul_rn(q1.z, px);
      const float az = __fmul_rn(q2.y, px);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float e01 = plane(a01, q0.y, py[i], q0.z);
        const float e12 = plane(a12, q1.x, py[i], q1.y);
        const float e20 = plane(a20, q1.w, py[i], q2.x);
        const float z = plane(az, q2.z, py[i], q2.w);
        if (e01 >= 0.f && e12 >= 0.f && e20 >= 0.f && z > iz[i]) {
          iz[i] = z;
          sg[i] = static_cast<int>(q3.x);
          r[i] = q3.y;
          g[i] = q3.z;
          bl[i] = q3.w;
        }
      }
    }
    __syncthreads();
  }

  if (col >= W) return;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = row0 + i;
    if (row < H) {
      const size_t p = (static_cast<size_t>(b) * H + row) * W + col;
      iz_out[p] = iz[i];
      seg_out[p] = sg[i];
      rgb_out[3 * p + 0] = r[i];
      rgb_out[3 * p + 1] = g[i];
      rgb_out[3 * p + 2] = bl[i];
    }
  }
}

}  // namespace

extern "C" int raster_tiles_launch(const float* table, const int* idx,
                                   const int* counts, float* iz, int* seg,
                                   float* rgb, int B, int F, int T, int K,
                                   int H, int W, void* stream) {
  if (B == 0 || T == 0 || W == 0) return 0;
  const int n_col_chunks = (W + kCols - 1) / kCols;
  const long long blocks = static_cast<long long>(B) * T * n_col_chunks;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  raster_tiles_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      table, idx, counts, iz, seg, rgb, F, T, K, H, W, n_col_chunks);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* raster_tiles_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
