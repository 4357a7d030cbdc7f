// Hand-written Hopper (sm_90a) kernels for the data path at scale.
//
//   K6 q16_decode       replaces gymfx_tpu/ops/tape_decode.py::decode_q16_block
//                       (pallas body _decode_kernel): the f32 view of a stacked
//                       block of compressed tape columns,
//                       out[c, j] = float(base[c] + int(delta[c, j])) / inv[c].
//   K7 scaled_windows   replaces gymfx_tpu/ops/window_zscore.py::
//                       batched_scaled_windows (pallas body _kernel): for each
//                       step s of a batch, the window padded_features[s : s+W]
//                       z-scored with that step's moments, zero where the step
//                       is neutral, clipped to +-clip when clip > 0.
//
// What bounds them: bytes.  Both are one pass of a few operations per
// element.  K6 reads 2 bytes and writes 4 per element (a whole 262,144-bar
// tape group of 5 columns is 7.9 MB, 2.3 us at 3.35 TB/s); K7 writes
// B x W x F f32 (262,143 x 32 x 5 at the export's shape: 167.8 MB, 50 us)
// and reads each feature row and moment row once.
//
// What the designs do about it.  K6: one thread per 8 elements of a row,
// a 2-D grid over (row chunk, column); when every row starts on a 16-byte
// boundary (rows % 8 == 0 and aligned pointers, decided by the wrapper)
// a thread does one 16-byte int16 load and two 16-byte f32 stores, else
// eight masked scalar accesses.  The base and the divisor are read from
// device memory: divisors stay runtime values, so the compiler cannot turn
// the division into a reciprocal multiply (the bitwise contract of
// gymfx_tpu/data/compress.py).  K7: one thread per four consecutive
// output elements of one step (W % 8 == 0, so a step's W x F face is a
// whole number of float4s): consecutive threads store consecutive 16-byte
// quads of the (B, W, F) output; a step's window is the contiguous run
// padded_features[s*F : (s+W)*F], so neighbouring threads read
// neighbouring addresses, and the overlapping windows of consecutive
// steps and the step's moment row come from L1/L2.  Each thread loads
// its own step index (no scalar prefetch).
//
// Clamping follows XLA's: K7's window start is clamped to
// [0, rows(padded_features) - W] (dynamic_slice) and its moment row to
// [0, rows(feat_mean) - 1] (gather).
//
// Bitwise contract with the plain PyTorch versions
// (gymfx_tpu_torch/ops/tape_decode.py, ops/window_zscore.py): build with
// -fmad=false and without --use_fast_math (IEEE division); int32 -> f32
// rounds to nearest (__int2float_rn, what a C cast does); clip is
// NaN-propagating max / min (fmaxf / fminf alone drop NaN); the neutral
// select is a select.  K7 does no nan_to_num: NaN and +-inf inputs pass
// through the z-score and the clip as XLA computes them.
//
// Each extern "C" entry point launches on the caller's stream, does not
// synchronise, and returns cudaGetLastError() (0 = launched).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float jmax(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : fmaxf(a, b));
}
__device__ __forceinline__ float jmin(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : fminf(a, b));
}

// ---------------------------------------------------------------- K6
__device__ __forceinline__ float decode_one(int base, short d, float inv) {
  return __int2float_rn(base + (int)d) / inv;
}

__global__ void q16_decode_kernel(const short* __restrict__ delta,
                                  const int* __restrict__ base,
                                  const float* __restrict__ inv,
                                  float* __restrict__ out, long long rows,
                                  int vectorized) {
  const int c = blockIdx.y;
  const long long j0 =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) * 8;
  if (j0 >= rows) return;
  const int b = base[c];
  const float v = inv[c];
  const short* src = delta + (long long)c * rows;
  float* dst = out + (long long)c * rows;
  if (vectorized) {
    // rows % 8 == 0: eight whole elements, one 16-byte load, two stores
    int4 raw = *reinterpret_cast<const int4*>(src + j0);
    const short* d = reinterpret_cast<const short*>(&raw);
    float4 lo = make_float4(decode_one(b, d[0], v), decode_one(b, d[1], v),
                            decode_one(b, d[2], v), decode_one(b, d[3], v));
    float4 hi = make_float4(decode_one(b, d[4], v), decode_one(b, d[5], v),
                            decode_one(b, d[6], v), decode_one(b, d[7], v));
    *reinterpret_cast<float4*>(dst + j0) = lo;
    *reinterpret_cast<float4*>(dst + j0 + 4) = hi;
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      long long j = j0 + k;
      if (j < rows) dst[j] = decode_one(b, src[j], v);
    }
  }
}

// ---------------------------------------------------------------- K7
__global__ void scaled_windows_kernel(const float* __restrict__ feats,
                                      const float* __restrict__ mean,
                                      const float* __restrict__ stdv,
                                      const unsigned char* __restrict__ neutral,
                                      const int* __restrict__ steps,
                                      float* __restrict__ out,
                                      long long quads, int face_quads,
                                      int features, long long max_start,
                                      long long max_moment, float clip) {
  long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= quads) return;
  long long b = q / face_quads;
  int e0 = (int)(q - b * face_quads) * 4;  // first element of this quad in the face
  long long s = steps[b];
  long long start = s < 0 ? 0 : (s > max_start ? max_start : s);
  long long row = s < 0 ? 0 : (s > max_moment ? max_moment : s);
  const float* win = feats + start * features;  // the window, contiguous
  const float* m = mean + row * features;
  const float* sd = stdv + row * features;
  const bool is_neutral = neutral[row] != 0;
  float v[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    int e = e0 + k;
    int f = e % features;
    float z = (win[e] - m[f]) / sd[f];
    float x = is_neutral ? 0.f : z;
    if (clip > 0.f) x = jmin(jmax(x, -clip), clip);
    v[k] = x;
  }
  reinterpret_cast<float4*>(out)[q] = make_float4(v[0], v[1], v[2], v[3]);
}

unsigned int blocks_for(long long n, int threads) {
  return (unsigned int)((n + threads - 1) / threads);
}

}  // namespace

extern "C" {

int gymfx_q16_decode(const void* delta, const void* base, const void* inv,
                     void* out, int columns, long long rows, int vectorized,
                     void* stream) {
  const int threads = 256;
  dim3 grid(blocks_for((rows + 7) / 8, threads), (unsigned int)columns);
  q16_decode_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const short*>(delta), static_cast<const int*>(base),
      static_cast<const float*>(inv), static_cast<float*>(out), rows,
      vectorized);
  return (int)cudaGetLastError();
}

int gymfx_scaled_windows(const void* feats, const void* mean, const void* stdv,
                         const void* neutral, const void* steps, void* out,
                         long long batch, int window, int features,
                         long long feature_rows, long long moment_rows,
                         float clip, void* stream) {
  const int threads = 256;
  int face_quads = window * features / 4;
  long long quads = batch * face_quads;
  scaled_windows_kernel<<<blocks_for(quads, threads), threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(feats), static_cast<const float*>(mean),
      static_cast<const float*>(stdv),
      static_cast<const unsigned char*>(neutral),
      static_cast<const int*>(steps), static_cast<float*>(out), quads,
      face_quads, features, feature_rows - window, moment_rows - 1, clip);
  return (int)cudaGetLastError();
}

}  // extern "C"
