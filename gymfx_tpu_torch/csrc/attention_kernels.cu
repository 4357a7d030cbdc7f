// Hand-written Hopper (sm_90a) kernels for K4, the fused window attention
// of the token policies (transformer_ring / transformer_ulysses).
//
//   attn_fwd_kernel  replaces gymfx_tpu/ops/fused_attention.py::_forward_batched
//                    (pallas body _kernel): o = softmax(q k^T * scale) v over
//                    the whole window, optionally causal, f32 inside.
//   attn_bwd_kernel  replaces gymfx_tpu/ops/fused_attention.py::_backward_batched
//                    (pallas body _bwd_kernel): recompute P from q and k, then
//                    dV = P^T dO, dP = dO V^T, dS = P (dP - rowsum(dP P)) scale,
//                    dQ = dS K, dK = dS^T Q.
//
// Layout: q, k, v, dO are read as (B, S, H, D) through their element
// strides (no transposes around the call); o, dq, dk, dv are written
// contiguous (B, S, H, D) in the input dtype (float32 or bfloat16).
// Arithmetic is float32.  S <= 1024, D <= 128.
//
// Why not the Pallas design: on the TPU a whole W x W f32 score block
// sits in VMEM (4 MB at W = 1024).  A Hopper block has 227 KB of shared
// memory and no state carried between blocks, so both kernels stream
// K/V (or Q/dO) tiles through shared memory and never form a score
// block.  The forward keeps an online softmax (running max and sum,
// output normalised at the end, as the Pallas forward divides PV by
// sum(p) after the product).  The backward is one block per (b, h):
//   phase 1  threads own query rows: pass A streams K/V to get the row
//            max m, the row sum l and delta = rowsum(dP P) (an online
//            sum of e * (dO . v) rescaled like l); pass B streams K/V
//            again for dQ with P normalised first (p = e / l), as
//            _bwd_kernel does.  m, l, delta stay in shared memory.
//   phase 2  threads own key rows and stream Q/dO tiles to accumulate
//            dK and dV in registers, so no atomics and no scratch in
//            device memory.
//
// What bounds them on the H100: operations.  At the update's shapes
// (B = 4096, S = 256, H = 4, D = 32, bf16) the forward moves ~1.07 GB
// (0.32 ms at 3.35 TB/s) against ~137 GFLOP (0.14 ms on the bf16 tensor
// cores, 2.0 ms at the 67 TFLOP/s f32 rate these kernels run at).  This
// first version is plain f32 FMA in CUDA cores: one row per thread group
// (TPR threads share a row, DPT dims each, partial dot products joined
// with warp shuffles), K/V rows read from shared memory as broadcast
// float4 loads.  wgmma, TMA and warp specialisation are later work.
//
// Each extern "C" entry point launches on the caller's stream, does not
// synchronise, allocates nothing, and returns cudaGetLastError()
// (0 = launched).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTileFloats = 4096;  // one shared-memory tile: rows x padded D
constexpr int kMaxWindow = 1024;

struct Strides {
  long long t[4][4];  // [q, k, v, dO][b, s, h, d], in elements
};

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// Thread part c of a row owns the float4 chunks c, c + TPR, c + 2 TPR, ...
// of the padded head dim: the TPR threads of a row read neighbouring
// 16-byte chunks of a shared-memory row, so a broadcast row read has no
// bank conflicts.
template <int TPR>
__device__ __forceinline__ int dim_of(int i, int e, int c) {
  return (i * TPR + c) * 4 + e;
}

template <typename T, int DPT, int TPR>
__device__ __forceinline__ void load_row(float (&r)[DPT], const T* row, long long sd,
                                         int D, int c, bool valid) {
#pragma unroll
  for (int i = 0; i < DPT / 4; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = dim_of<TPR>(i, e, c);
      r[4 * i + e] = (valid && d < D) ? ld(row + d * sd) : 0.f;
    }
  }
}

template <typename T, int DPT, int TPR>
__device__ __forceinline__ void store_row(T* row, const float (&r)[DPT], int D, int c) {
#pragma unroll
  for (int i = 0; i < DPT / 4; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = dim_of<TPR>(i, e, c);
      if (d < D) put(row + d, r[4 * i + e]);
    }
  }
}

// Full dot product of a row held in registers (split over the TPR
// threads of the row) with a shared-memory row; every thread of the row
// gets the sum.  Called uniformly by the whole block (shuffles).
template <int DPT, int TPR>
__device__ __forceinline__ float dot_row(const float (&r)[DPT], const float4* row, int c) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < DPT / 4; ++i) {
    const float4 x = row[i * TPR + c];
    s += r[4 * i] * x.x;
    s += r[4 * i + 1] * x.y;
    s += r[4 * i + 2] * x.z;
    s += r[4 * i + 3] * x.w;
  }
#pragma unroll
  for (int o = TPR / 2; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

template <int DPT, int TPR>
__device__ __forceinline__ void axpy_row(float (&acc)[DPT], float a, const float4* row, int c) {
#pragma unroll
  for (int i = 0; i < DPT / 4; ++i) {
    const float4 x = row[i * TPR + c];
    acc[4 * i] += a * x.x;
    acc[4 * i + 1] += a * x.y;
    acc[4 * i + 2] += a * x.z;
    acc[4 * i + 3] += a * x.w;
  }
}

// Rows r0 .. r0 + kTileFloats / DPAD - 1 of one (b, h) slice into a
// shared-memory tile [rows][DPAD], zero past S and past D.
template <typename T, int DPAD>
__device__ __forceinline__ void load_tile(float* tile, const T* base, long long ss,
                                          long long sd, int r0, int S, int D) {
  for (int e = threadIdx.x; e < kTileFloats; e += kThreads) {
    const int j = r0 + e / DPAD, d = e % DPAD;
    tile[e] = (j < S && d < D) ? ld(base + j * ss + d * sd) : 0.f;
  }
}

template <typename T, int DPT, int TPR>
__global__ void __launch_bounds__(kThreads)
attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                T* __restrict__ o, Strides st, int S, int H, int D, int causal,
                float scale, int ntiles) {
  constexpr int ROWS = kThreads / TPR, DPAD = DPT * TPR, TILE = kTileFloats / DPAD;
  constexpr int CH = 16;  // keys scored per online-softmax update
  __shared__ __align__(16) float ks[kTileFloats];
  __shared__ __align__(16) float vs[kTileFloats];
  const float4* ks4 = reinterpret_cast<const float4*>(ks);
  const float4* vs4 = reinterpret_cast<const float4*>(vs);

  const int tile = blockIdx.x % ntiles;
  const int bh = blockIdx.x / ntiles;
  const int h = bh % H, b = bh / H;
  const int r = threadIdx.x / TPR, c = threadIdx.x % TPR;
  const int q0 = tile * ROWS, i = q0 + r;
  const bool valid = i < S;

  const long long(&t)[4][4] = st.t;
  const T* qb = q + b * t[0][0] + h * t[0][2];
  const T* kb = k + b * t[1][0] + h * t[1][2];
  const T* vb = v + b * t[2][0] + h * t[2][2];

  float qr[DPT], acc[DPT];
  load_row<T, DPT, TPR>(qr, qb + (valid ? i : 0) * t[0][1], t[0][3], D, c, valid);
#pragma unroll
  for (int d = 0; d < DPT; ++d) acc[d] = 0.f;
  float m = -INFINITY, l = 0.f;

  const int kend = causal ? min(S, q0 + ROWS) : S;
  for (int k0 = 0; k0 < kend; k0 += TILE) {
    __syncthreads();
    load_tile<T, DPAD>(ks, kb, t[1][1], t[1][3], k0, S, D);
    load_tile<T, DPAD>(vs, vb, t[2][1], t[2][3], k0, S, D);
    __syncthreads();
    const int nk = min(TILE, kend - k0);
    for (int j0 = 0; j0 < nk; j0 += CH) {
      float s[CH];
      float mt = m;
#pragma unroll
      for (int u = 0; u < CH; ++u) {
        const int j = j0 + u;
        float x = -INFINITY;
        if (j < nk) {  // uniform across the block
          x = dot_row<DPT, TPR>(qr, ks4 + j * (DPAD / 4), c) * scale;
          if (causal && k0 + j > i) x = -INFINITY;
        }
        s[u] = x;
        mt = fmaxf(mt, x);
      }
      if (mt != -INFINITY) {
        const float alpha = expf(m - mt);
        l *= alpha;
#pragma unroll
        for (int d = 0; d < DPT; ++d) acc[d] *= alpha;
#pragma unroll
        for (int u = 0; u < CH; ++u) {
          if (j0 + u < nk) {
            const float p = expf(s[u] - mt);
            l += p;
            axpy_row<DPT, TPR>(acc, p, vs4 + (j0 + u) * (DPAD / 4), c);
          }
        }
        m = mt;
      }
    }
  }
  if (valid) {
#pragma unroll
    for (int d = 0; d < DPT; ++d) acc[d] /= l;
    store_row<T, DPT, TPR>(o + ((static_cast<long long>(b) * S + i) * H + h) * D, acc, D, c);
  }
}

template <typename T, int DPT, int TPR>
__global__ void __launch_bounds__(kThreads)
attn_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ g, T* __restrict__ dq, T* __restrict__ dk,
                T* __restrict__ dv, Strides st, int S, int H, int D, int causal,
                float scale) {
  constexpr int ROWS = kThreads / TPR, DPAD = DPT * TPR, TILE = kTileFloats / DPAD;
  constexpr int CH = 8;
  __shared__ __align__(16) float t0[kTileFloats];
  __shared__ __align__(16) float t1[kTileFloats];
  __shared__ float row_m[kMaxWindow], row_l[kMaxWindow], row_delta[kMaxWindow];
  const float4* t04 = reinterpret_cast<const float4*>(t0);
  const float4* t14 = reinterpret_cast<const float4*>(t1);

  const int h = blockIdx.x % H, b = blockIdx.x / H;
  const int r = threadIdx.x / TPR, c = threadIdx.x % TPR;
  const long long(&t)[4][4] = st.t;
  const T* qb = q + b * t[0][0] + h * t[0][2];
  const T* kb = k + b * t[1][0] + h * t[1][2];
  const T* vb = v + b * t[2][0] + h * t[2][2];
  const T* gb = g + b * t[3][0] + h * t[3][2];
  const long long out_row = static_cast<long long>(H) * D;
  const long long out_base = static_cast<long long>(b) * S * out_row + static_cast<long long>(h) * D;

  // ---- phase 1: query rows; row statistics and dQ -------------------------
  for (int q0 = 0; q0 < S; q0 += ROWS) {
    const int i = q0 + r;
    const bool valid = i < S;
    float qr[DPT], gr[DPT], dqr[DPT];
    load_row<T, DPT, TPR>(qr, qb + (valid ? i : 0) * t[0][1], t[0][3], D, c, valid);
    load_row<T, DPT, TPR>(gr, gb + (valid ? i : 0) * t[3][1], t[3][3], D, c, valid);
    const int kend = causal ? min(S, q0 + ROWS) : S;

    // pass A: m, l and delta = sum_j p_ij (dO_i . v_j), online
    float m = -INFINITY, l = 0.f, acc = 0.f;
    for (int k0 = 0; k0 < kend; k0 += TILE) {
      __syncthreads();
      load_tile<T, DPAD>(t0, kb, t[1][1], t[1][3], k0, S, D);
      load_tile<T, DPAD>(t1, vb, t[2][1], t[2][3], k0, S, D);
      __syncthreads();
      const int nk = min(TILE, kend - k0);
      for (int j0 = 0; j0 < nk; j0 += CH) {
        float s[CH], dpv[CH];
        float mt = m;
#pragma unroll
        for (int u = 0; u < CH; ++u) {
          const int j = j0 + u;
          float x = -INFINITY, y = 0.f;
          if (j < nk) {
            x = dot_row<DPT, TPR>(qr, t04 + j * (DPAD / 4), c) * scale;
            y = dot_row<DPT, TPR>(gr, t14 + j * (DPAD / 4), c);
            if (causal && k0 + j > i) x = -INFINITY;
          }
          s[u] = x;
          dpv[u] = y;
          mt = fmaxf(mt, x);
        }
        if (mt != -INFINITY) {
          const float alpha = expf(m - mt);
          l *= alpha;
          acc *= alpha;
#pragma unroll
          for (int u = 0; u < CH; ++u) {
            if (j0 + u < nk) {
              const float e = expf(s[u] - mt);
              l += e;
              acc += e * dpv[u];
            }
          }
          m = mt;
        }
      }
    }
    const float delta = acc / l;

    // pass B: dQ_i = sum_j dS_ij k_j with p = e / l
#pragma unroll
    for (int d = 0; d < DPT; ++d) dqr[d] = 0.f;
    for (int k0 = 0; k0 < kend; k0 += TILE) {
      __syncthreads();
      load_tile<T, DPAD>(t0, kb, t[1][1], t[1][3], k0, S, D);
      load_tile<T, DPAD>(t1, vb, t[2][1], t[2][3], k0, S, D);
      __syncthreads();
      const int nk = min(TILE, kend - k0);
      for (int j = 0; j < nk; ++j) {
        float x = dot_row<DPT, TPR>(qr, t04 + j * (DPAD / 4), c) * scale;
        const float dp = dot_row<DPT, TPR>(gr, t14 + j * (DPAD / 4), c);
        if (causal && k0 + j > i) x = -INFINITY;
        const float p = expf(x - m) / l;
        const float ds = p * (dp - delta) * scale;
        axpy_row<DPT, TPR>(dqr, ds, t04 + j * (DPAD / 4), c);
      }
    }
    if (valid) {
      store_row<T, DPT, TPR>(dq + out_base + i * out_row, dqr, D, c);
      if (c == 0) {
        row_m[i] = m;
        row_l[i] = l;
        row_delta[i] = delta;
      }
    }
  }
  __syncthreads();

  // ---- phase 2: key rows; dK and dV ---------------------------------------
  for (int j0 = 0; j0 < S; j0 += ROWS) {
    const int j = j0 + r;
    const bool valid = j < S;
    float kr[DPT], vr[DPT], dkr[DPT], dvr[DPT];
    load_row<T, DPT, TPR>(kr, kb + (valid ? j : 0) * t[1][1], t[1][3], D, c, valid);
    load_row<T, DPT, TPR>(vr, vb + (valid ? j : 0) * t[2][1], t[2][3], D, c, valid);
#pragma unroll
    for (int d = 0; d < DPT; ++d) {
      dkr[d] = 0.f;
      dvr[d] = 0.f;
    }
    const int istart = causal ? (j0 / TILE) * TILE : 0;
    for (int i0 = istart; i0 < S; i0 += TILE) {
      __syncthreads();
      load_tile<T, DPAD>(t0, qb, t[0][1], t[0][3], i0, S, D);
      load_tile<T, DPAD>(t1, gb, t[3][1], t[3][3], i0, S, D);
      __syncthreads();
      const int ni = min(TILE, S - i0);
      for (int ii = 0; ii < ni; ++ii) {
        const int i = i0 + ii;
        float x = dot_row<DPT, TPR>(kr, t04 + ii * (DPAD / 4), c) * scale;
        const float dp = dot_row<DPT, TPR>(vr, t14 + ii * (DPAD / 4), c);
        if (causal && j > i) x = -INFINITY;
        const float p = expf(x - row_m[i]) / row_l[i];
        const float ds = p * (dp - row_delta[i]) * scale;
        axpy_row<DPT, TPR>(dvr, p, t14 + ii * (DPAD / 4), c);
        axpy_row<DPT, TPR>(dkr, ds, t04 + ii * (DPAD / 4), c);
      }
    }
    if (valid) {
      store_row<T, DPT, TPR>(dk + out_base + j * out_row, dkr, D, c);
      store_row<T, DPT, TPR>(dv + out_base + j * out_row, dvr, D, c);
    }
  }
}

Strides read_strides(const long long* s, int n) {
  Strides st{};
  for (int a = 0; a < n; ++a)
    for (int x = 0; x < 4; ++x) st.t[a][x] = s[4 * a + x];
  return st;
}

template <typename T, int DPT, int TPR>
int launch_fwd(const void* q, const void* k, const void* v, void* o, const Strides& st,
               int B, int S, int H, int D, int causal, float scale, cudaStream_t stream) {
  constexpr int ROWS = kThreads / TPR;
  const int ntiles = (S + ROWS - 1) / ROWS;
  const long long blocks = static_cast<long long>(B) * H * ntiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  attn_fwd_kernel<T, DPT, TPR><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), st, S, H, D, causal, scale, ntiles);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DPT, int TPR>
int launch_bwd(const void* q, const void* k, const void* v, const void* g, void* dq,
               void* dk, void* dv, const Strides& st, int B, int S, int H, int D,
               int causal, float scale, cudaStream_t stream) {
  const long long blocks = static_cast<long long>(B) * H;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  attn_bwd_kernel<T, DPT, TPR><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(g), static_cast<T*>(dq), static_cast<T*>(dk),
      static_cast<T*>(dv), st, S, H, D, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_fwd(const void* q, const void* k, const void* v, void* o, const Strides& st,
                 int B, int S, int H, int D, int causal, float scale, cudaStream_t s) {
  if (D <= 16) return launch_fwd<T, 16, 1>(q, k, v, o, st, B, S, H, D, causal, scale, s);
  if (D <= 32) return launch_fwd<T, 32, 1>(q, k, v, o, st, B, S, H, D, causal, scale, s);
  if (D <= 64) return launch_fwd<T, 32, 2>(q, k, v, o, st, B, S, H, D, causal, scale, s);
  return launch_fwd<T, 32, 4>(q, k, v, o, st, B, S, H, D, causal, scale, s);
}

template <typename T>
int dispatch_bwd(const void* q, const void* k, const void* v, const void* g, void* dq,
                 void* dk, void* dv, const Strides& st, int B, int S, int H, int D,
                 int causal, float scale, cudaStream_t s) {
  if (D <= 16) return launch_bwd<T, 16, 1>(q, k, v, g, dq, dk, dv, st, B, S, H, D, causal, scale, s);
  if (D <= 32) return launch_bwd<T, 16, 2>(q, k, v, g, dq, dk, dv, st, B, S, H, D, causal, scale, s);
  if (D <= 64) return launch_bwd<T, 16, 4>(q, k, v, g, dq, dk, dv, st, B, S, H, D, causal, scale, s);
  return launch_bwd<T, 16, 8>(q, k, v, g, dq, dk, dv, st, B, S, H, D, causal, scale, s);
}

bool bad_shape(int B, int S, int H, int D) {
  return B < 1 || H < 1 || S < 1 || S > kMaxWindow || D < 1 || D > 128;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  strides: 12 (q, k, v) element
// strides in (b, s, h, d) order.
int gymfx_attn_fwd(const void* q, const void* k, const void* v, void* o,
                   const long long* strides, int dtype, int B, int S, int H, int D,
                   int causal, float scale, void* stream) {
  if (bad_shape(B, S, H, D) || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides st = read_strides(strides, 3);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_fwd<float>(q, k, v, o, st, B, S, H, D, causal, scale, s);
  return dispatch_fwd<__nv_bfloat16>(q, k, v, o, st, B, S, H, D, causal, scale, s);
}

// strides: 16 (q, k, v, dO) element strides in (b, s, h, d) order.
int gymfx_attn_bwd(const void* q, const void* k, const void* v, const void* g, void* dq,
                   void* dk, void* dv, const long long* strides, int dtype, int B, int S,
                   int H, int D, int causal, float scale, void* stream) {
  if (bad_shape(B, S, H, D) || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides st = read_strides(strides, 4);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_bwd<float>(q, k, v, g, dq, dk, dv, st, B, S, H, D, causal, scale, s);
  return dispatch_bwd<__nv_bfloat16>(q, k, v, g, dq, dk, dv, st, B, S, H, D, causal, scale, s);
}

}  // extern "C"
