// Vertex stage and per-band binning of the tiled rasterizer for Hopper
// (sm_90a): face records and each 16-row band's stable face list.
//
// Replaces the jnp stages inside the TPU kernel's function
// `pallas_rasterize_tiles` in maniskill_tpu/render/pallas_rasterizer.py
// (the vertex stage, lines 113-158, and the binning, lines 160-181), whose
// plain torch versions are `face_records` and `bin_faces` in
// maniskill_tpu_torch/render/tiled_rasterizer.py. Its outputs are bit-equal
// to theirs, and feed csrc/raster_tiles.cu.
//
// Inputs (B envs, F faces, T = ceil(H / 16) bands)
//   fx, fy, inv_z (B, F, 3) f32  screen x, y and 1/z per corner
//   ok            (B, F)    i32  face enabled (front-facing, in front)
//   face_rgb      (B, F, 3) f32  pre-shaded flat colour
//   face_seg      (F,)      i32  segmentation id
// Outputs
//   table  (B, F, 16) f32  [e01 a,b,c, e12 a,b,c, e20 a,b,c, 1/z a,b,c, seg,
//                           r, g, b]: sign-folded edge planes (a = b = 0,
//                           c = -1 for an invalid face) and the 1/z plane
//   valid  (B, F)     u8   enabled and not degenerate (|area| >= 1e-9)
//   idx    (B, T, F)  i32  per band, the ids of the faces that overlap it in
//                          face order, then every other id in face order:
//                          the whole stable partition, as the stable
//                          argsort of `bin_faces` gives it
//   counts (B, T)     i32  overlapping faces per band
//
// Arithmetic: every operation of `face_records` is one explicitly rounded
// intrinsic (__fmul_rn, __fadd_rn, __fsub_rn) in torch's order, so nothing
// contracts into an FMA; torch computes `1.0 / t` as a reciprocal (then a
// product by 1), so inv_area is __frcp_rn; `torch.sign` is (0 < x) - (x < 0),
// 0 for NaN; `amin`/`amax` propagate NaN, so a NaN corner makes every bound
// test false as in torch.
//
// What bounds it: bytes. Per face it does ~60 FP32 operations against 52
// bytes read and 65 + 4T written (725 MB at PickCube's 2048 envs x 2,374
// faces x 8 bands: 253 MB read, 316 MB of records and flags, 156 MB of
// id lists).
// Design: one block of 256 threads per (env, band). Pass 1 walks the env's
// faces a warp-sized word at a time; each lane computes its face's bounding
// box and validity, and `__ballot_sync` packs the band's overlap bits into a
// word in shared memory. The block whose band index equals the word index
// modulo T also writes those 32 faces' records and validity, so every
// record is written once and the blocks share that work. Pass 2 is a block
// prefix sum over the words' popcounts. Pass 3 writes the list: a face's
// slot is the number of overlapping faces before it (the word's prefix plus
// `__popc` of the lower lanes) if it overlaps, else count + its id minus
// that number. No sort and no (B, T, F) mask in device memory; each block
// re-reads its env's 28 bytes of corners and flags per face, from L2 when
// the env's bands run together (they are adjacent in the grid).

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileH = 16;

__device__ __forceinline__ float min3_nan(float a, float b, float c) {
  if (isnan(a) || isnan(b) || isnan(c)) return __int_as_float(0x7fc00000);
  return fminf(fminf(a, b), c);
}

__device__ __forceinline__ float max3_nan(float a, float b, float c) {
  if (isnan(a) || isnan(b) || isnan(c)) return __int_as_float(0x7fc00000);
  return fmaxf(fmaxf(a, b), c);
}

// signed doubled area (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0)
__device__ __forceinline__ float face_area(const float* x, const float* y) {
  return __fsub_rn(__fmul_rn(__fsub_rn(x[1], x[0]), __fsub_rn(y[2], y[0])),
                   __fmul_rn(__fsub_rn(y[1], y[0]), __fsub_rn(x[2], x[0])));
}

struct Edge {
  float a, b, c;
};

// e(p) = (xb-xa)*(py-ya) - (yb-ya)*(px-xa), premultiplied by s; an invalid
// face gets a = b = 0, c = -1
__device__ __forceinline__ Edge edge(float xa, float ya, float xb, float yb, float s, bool valid) {
  const float dy = __fsub_rn(yb, ya);
  const float dx = __fsub_rn(xb, xa);
  Edge e;
  e.a = valid ? __fmul_rn(-s, dy) : 0.f;
  e.b = valid ? __fmul_rn(s, dx) : 0.f;
  e.c = valid ? __fmul_rn(s, __fsub_rn(__fmul_rn(dy, xa), __fmul_rn(dx, ya))) : -1.f;
  return e;
}

// (e12 * iz0 + e20 * iz1 + e01 * iz2) * s * inv_area
__device__ __forceinline__ float zc(float k12, float k20, float k01, const float* iz, float s, float inv) {
  const float sum = __fadd_rn(__fadd_rn(__fmul_rn(k12, iz[0]), __fmul_rn(k20, iz[1])), __fmul_rn(k01, iz[2]));
  return __fmul_rn(__fmul_rn(sum, s), inv);
}

__global__ void __launch_bounds__(kThreads)
raster_setup_kernel(const float* __restrict__ fx, const float* __restrict__ fy,
                    const float* __restrict__ inv_z, const int* __restrict__ ok,
                    const float* __restrict__ face_rgb, const int* __restrict__ face_seg,
                    float* __restrict__ table, unsigned char* __restrict__ valid_out,
                    int* __restrict__ idx, int* __restrict__ counts,
                    int F, int T, int H, int W) {
  extern __shared__ unsigned int smem[];
  const int n_words = (F + 31) / 32;
  unsigned int* words = smem;            // overlap bits, 32 faces a word
  unsigned int* prefix = smem + n_words;  // overlapping faces before each word
  __shared__ unsigned int warp_sums[kWarps];

  const int bt = blockIdx.x;
  const int b = bt / T;
  const int t = bt % T;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float band_lo = __fmul_rn(static_cast<float>(t), static_cast<float>(kTileH));
  const float band_hi = __fadd_rn(band_lo, static_cast<float>(kTileH));
  const float fw = static_cast<float>(W), fh = static_cast<float>(H);
  const size_t env = static_cast<size_t>(b) * F;

  // ---- pass 1: overlap bits (and, for this block's words, the records) ----
  for (int w = warp; w < n_words; w += kWarps) {
    const int f = w * 32 + lane;
    bool overlap = false;
    if (f < F) {
      const size_t e = env + f;
      float x[3], y[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        x[k] = fx[3 * e + k];
        y[k] = fy[3 * e + k];
      }
      const float area = face_area(x, y);
      const bool degenerate = fabsf(area) < 1e-9f;
      const bool valid = ok[e] > 0 && !degenerate;
      const float xmin = min3_nan(x[0], x[1], x[2]), xmax = max3_nan(x[0], x[1], x[2]);
      const float ymin = min3_nan(y[0], y[1], y[2]), ymax = max3_nan(y[0], y[1], y[2]);
      const bool on_screen = valid && xmax >= 0.f && xmin < fw && ymax >= 0.f && ymin < fh;
      overlap = on_screen && ymax >= band_lo && ymin < band_hi;
      if (w % T == t) {
        const float safe_area = degenerate ? 1e-9f : area;
        const float s = static_cast<float>(static_cast<int>(0.f < safe_area) - static_cast<int>(safe_area < 0.f));
        const float inv_area = __frcp_rn(safe_area);
        float iz[3];
#pragma unroll
        for (int k = 0; k < 3; ++k) iz[k] = inv_z[3 * e + k];
        const Edge e01 = edge(x[0], y[0], x[1], y[1], s, valid);
        const Edge e12 = edge(x[1], y[1], x[2], y[2], s, valid);
        const Edge e20 = edge(x[2], y[2], x[0], y[0], s, valid);
        float4* rec = reinterpret_cast<float4*>(table) + 4 * e;
        rec[0] = make_float4(e01.a, e01.b, e01.c, e12.a);
        rec[1] = make_float4(e12.b, e12.c, e20.a, e20.b);
        rec[2] = make_float4(e20.c, zc(e12.a, e20.a, e01.a, iz, s, inv_area),
                             zc(e12.b, e20.b, e01.b, iz, s, inv_area), zc(e12.c, e20.c, e01.c, iz, s, inv_area));
        rec[3] = make_float4(static_cast<float>(face_seg[f]), face_rgb[3 * e + 0], face_rgb[3 * e + 1],
                             face_rgb[3 * e + 2]);
        valid_out[e] = valid ? 1 : 0;
      }
    }
    const unsigned int bits = __ballot_sync(0xffffffffu, overlap);
    if (lane == 0) words[w] = bits;
  }
  __syncthreads();

  // ---- pass 2: exclusive prefix of the words' popcounts -------------------
  const int per = (n_words + kThreads - 1) / kThreads;
  const int w0 = min(n_words, static_cast<int>(threadIdx.x) * per);
  const int w1 = min(n_words, w0 + per);
  unsigned int mine = 0;
  for (int w = w0; w < w1; ++w) mine += __popc(words[w]);
  unsigned int incl = mine;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned int v = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  unsigned int before = incl - mine;
  unsigned int total = 0;
  for (int k = 0; k < kWarps; ++k) {
    if (k < warp) before += warp_sums[k];
    total += warp_sums[k];
  }
  for (int w = w0; w < w1; ++w) {
    prefix[w] = before;
    before += __popc(words[w]);
  }
  if (threadIdx.x == 0) counts[bt] = static_cast<int>(total);
  __syncthreads();

  // ---- pass 3: the stable partition -------------------------------------
  int* list = idx + static_cast<size_t>(bt) * F;
  for (int w = warp; w < n_words; w += kWarps) {
    const int f = w * 32 + lane;
    if (f < F) {
      const unsigned int bits = words[w];
      const unsigned int ahead = prefix[w] + __popc(bits & ((1u << lane) - 1u));
      const bool overlap = (bits >> lane) & 1u;
      list[overlap ? ahead : total + (f - ahead)] = f;
    }
  }
}

}  // namespace

extern "C" int raster_setup_launch(const float* fx, const float* fy, const float* inv_z, const int* ok,
                                   const float* face_rgb, const int* face_seg, float* table,
                                   unsigned char* valid, int* idx, int* counts, int B, int F, int T,
                                   int H, int W, void* stream) {
  if (B == 0 || T == 0) return 0;
  const long long blocks = static_cast<long long>(B) * T;
  if (blocks > INT_MAX || F <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const size_t smem = 2 * sizeof(unsigned int) * static_cast<size_t>((F + 31) / 32);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(raster_setup_kernel,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  raster_setup_kernel<<<static_cast<unsigned>(blocks), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      fx, fy, inv_z, ok, face_rgb, face_seg, table, valid, idx, counts, F, T, H, W);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* raster_setup_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
