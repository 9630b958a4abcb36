// Tiled triangle rasterizer for Hopper (sm_90a): coverage, 1/z test and
// flat shading of pre-binned faces, one 16 x 32 pixel tile per block.
//
// Replaces the Pallas TPU kernel `_raster_kernel` in
// maniskill_tpu/render/pallas_rasterizer.py (called by
// `pallas_rasterize_tiles`). Its inputs come from csrc/raster_setup.cu (or
// from the plain `face_records` and `bin_faces` in
// maniskill_tpu_torch/render/tiled_rasterizer.py); its plain version is
// `raster_bands_ref` there, to which its outputs are bit-equal.
//
// Inputs
//   table  (B, F, 16) f32  per-face records
//          [e01 a,b,c, e12 a,b,c, e20 a,b,c, 1/z a,b,c, seg, r, g, b]
//   idx    (B, T, K) i32   per 16-row band, the overlapping face ids in
//                          list order (stable); the wrapper passes K = F,
//                          so no band's list is ever cut
//   counts (B, T)    i32   live entries of each band's list; a block walks
//                          all of them, however many
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
// (__fmul_rn/__fadd_rn), so FMA contraction cannot move edge pixels.
//
// What bounds it: the pixel-face tests (~21 FP32 instructions each) of the
// faces that reach a warp's strip, or on frames with few faces per band the
// 20 bytes written per pixel; the records are read from L2 once per tile.
// The TPU kernel owns a whole (16, W) band and tests every face of the band
// against every column; on the ported tasks' frames 89-99% of those tests
// fall outside the face's x-range (`raster_work` counts both). So this
// kernel:
// - owns a 16-row x 32-column tile per block (64 threads, two warps; a lane
//   owns one column, a warp 8 rows; the pixel state lives in registers and
//   the per-column products a*px are hoisted out of the row loop). 32
//   columns is a warp's width, so the coverage tests are uniform per warp,
//   and a 128x128 frame at 2048 envs makes 65,536 blocks (~50 waves of the
//   ten 96-register blocks an SM holds), while one env (8 bands x 4 tiles)
//   still puts 32 blocks on the card.
// - culls each band's list per warp, in list order: a chunk of 64 records
//   is staged, each thread tests one record against each warp's 8 x 32
//   strip of pixel centres, and `__ballot_sync`/`__popc` and a two-warp
//   prefix compact the slots kept for either strip, in order, with a bit
//   per strip, into a list in shared memory; a warp skips (uniformly) the
//   records not flagged for its strip. The test is exact, not a margin: a
//   rounded plane (a*px + b*py) + c is monotone in px and in py separately
//   (rounding is monotone), so its largest value on a rectangle is at the
//   corner picked by the signs of a and b. A record whose edge plane is < 0
//   at that corner for any edge, or whose 1/z plane is <= 0 there, covers no
//   pixel of the strip with 1/z > 0, so dropping it changes no pixel (NaN
//   at a corner keeps it). `cull_tiles_ref` in tiled_rasterizer.py is this
//   rule in plain torch. (A margin on the face's x-range instead is not
//   exact: a needle's long edges can both round to >= 0 pixels past its tip.)
// - stages through a two-slot ring of shared memory (2 x 64 records, 8 KB)
//   with 16-byte `cp.async` copies gathered by face id (no box for TMA), so
//   the next chunk loads while the current one is culled and tested.
// Ragged rows and columns are masked at the store, so H and W need not be
// multiples of 16 or 32.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int kTileH = 16;
constexpr int kCols = 32;
constexpr int kThreads = 64;
constexpr int kRows = kTileH * kCols / kThreads;  // rows per thread: 8
constexpr int kChunk = kThreads;                  // records staged per pass

__device__ __forceinline__ float plane(float a_px, float b, float py, float c) {
  return __fadd_rn(__fadd_rn(a_px, __fmul_rn(b, py)), c);
}

// the plane's largest rounded value over [px_lo, px_hi] x [py_lo, py_hi]
__device__ __forceinline__ float plane_max(float a, float b, float c, float px_lo, float px_hi,
                                           float py_lo, float py_hi) {
  return plane(__fmul_rn(a, a > 0.f ? px_hi : px_lo), b, b > 0.f ? py_hi : py_lo, c);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned int s = static_cast<unsigned int>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_one() { asm volatile("cp.async.wait_group 1;\n" ::); }

__global__ void __launch_bounds__(kThreads)
raster_tiles_kernel(const float* __restrict__ table,
                    const int* __restrict__ idx,
                    const int* __restrict__ counts,
                    float* __restrict__ iz_out,
                    int* __restrict__ seg_out,
                    float* __restrict__ rgb_out,
                    int F, int T, int K, int H, int W, int n_tiles) {
  __shared__ __align__(16) float4 ring[2][kChunk][4];
  __shared__ int survivors[kChunk];
  __shared__ int warp_kept[2];

  const int tile = blockIdx.x % n_tiles;
  const int bt = blockIdx.x / n_tiles;  // env * T + band
  const int b = bt / T;
  const int t = bt % T;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int col0 = tile * kCols;
  const int col = col0 + lane;
  const int row0 = t * kTileH + warp * kRows;

  // the pixel centres of the two warps' 8 x 32 strips, exactly as the
  // coverage tests compute them
  const float px_lo = static_cast<float>(col0) + 0.5f;
  const float px_hi = static_cast<float>(col0 + kCols - 1) + 0.5f;
  float py_lo[2], py_hi[2];
#pragma unroll
  for (int w = 0; w < 2; ++w) {
    py_lo[w] = static_cast<float>(t * kTileH + w * kRows) + 0.5f;
    py_hi[w] = static_cast<float>(t * kTileH + w * kRows + kRows - 1) + 0.5f;
  }

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
  const int n_chunks = (n + kChunk - 1) / kChunk;

  auto stage = [&](int chunk, int slot) {
    const int j = chunk * kChunk + static_cast<int>(threadIdx.x);
    if (j < n) {
      const float4* src = tab + static_cast<size_t>(list[j]) * 4;
#pragma unroll
      for (int q = 0; q < 4; ++q) cp_async16(&ring[slot][threadIdx.x][q], src + q);
    }
  };

  if (n_chunks > 0) stage(0, 0);
  cp_async_commit();
  for (int k = 0; k < n_chunks; ++k) {
    const int slot = k & 1;
    if (k + 1 < n_chunks) stage(k + 1, slot ^ 1);
    cp_async_commit();  // one group per iteration, empty on the last
    cp_async_wait_one();
    __syncthreads();

    // cull: one record per thread against each warp's strip, then a stable
    // compaction of the slots kept for either strip, with a bit per strip
    const int m = min(kChunk, n - k * kChunk);
    int strips = 0;
    if (static_cast<int>(threadIdx.x) < m) {
      const float4* q = ring[slot][threadIdx.x];
      const float4 q0 = q[0], q1 = q[1], q2 = q[2];
#pragma unroll
      for (int w = 0; w < 2; ++w) {
        const float m01 = plane_max(q0.x, q0.y, q0.z, px_lo, px_hi, py_lo[w], py_hi[w]);
        const float m12 = plane_max(q0.w, q1.x, q1.y, px_lo, px_hi, py_lo[w], py_hi[w]);
        const float m20 = plane_max(q1.z, q1.w, q2.x, px_lo, px_hi, py_lo[w], py_hi[w]);
        const float mz = plane_max(q2.y, q2.z, q2.w, px_lo, px_hi, py_lo[w], py_hi[w]);
        if (!(m01 < 0.f) && !(m12 < 0.f) && !(m20 < 0.f) && !(mz <= 0.f)) strips |= 1 << w;
      }
    }
    const unsigned int kept = __ballot_sync(0xffffffffu, strips != 0);
    if (lane == 0) warp_kept[warp] = __popc(kept);
    __syncthreads();
    if (strips) {
      survivors[(warp ? warp_kept[0] : 0) + __popc(kept & ((1u << lane) - 1u))] = (strips << 8) | threadIdx.x;
    }
    const int n_kept = warp_kept[0] + warp_kept[1];
    __syncthreads();

    for (int j = 0; j < n_kept; ++j) {
      const int s = survivors[j];
      if (!((s >> (8 + warp)) & 1)) continue;  // misses this warp's strip: uniform
      const float4* q = ring[slot][s & 0xff];
      const float4 q0 = q[0];  // a01 b01 c01 a12
      const float4 q1 = q[1];  // b12 c12 a20 b20
      const float4 q2 = q[2];  // c20 za  zb  zc
      const float a01 = __fmul_rn(q0.x, px);
      const float a12 = __fmul_rn(q0.w, px);
      const float a20 = __fmul_rn(q1.z, px);
      const float az = __fmul_rn(q2.y, px);
      unsigned int won = 0;
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float e01 = plane(a01, q0.y, py[i], q0.z);
        const float e12 = plane(a12, q1.x, py[i], q1.y);
        const float e20 = plane(a20, q1.w, py[i], q2.x);
        const float z = plane(az, q2.z, py[i], q2.w);
        if (e01 >= 0.f && e12 >= 0.f && e20 >= 0.f && z > iz[i]) {
          iz[i] = z;
          won |= 1u << i;
        }
      }
      if (won) {
        const float4 q3 = q[3];  // seg r g b
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          if (won & (1u << i)) {
            sg[i] = static_cast<int>(q3.x);
            r[i] = q3.y;
            g[i] = q3.z;
            bl[i] = q3.w;
          }
        }
      }
    }
    __syncthreads();  // the slot and the survivor list are refilled next
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
  const int n_tiles = (W + kCols - 1) / kCols;
  const long long blocks = static_cast<long long>(B) * T * n_tiles;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  raster_tiles_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      table, idx, counts, iz, seg, rgb, F, T, K, H, W, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* raster_tiles_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
