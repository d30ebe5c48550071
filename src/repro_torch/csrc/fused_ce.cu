// Fused cross-entropy forward on Hopper: per-token loss lse(h @ w) - (h @ w)[label]
// without the (T, V) logits ever reaching device memory.
//
// Replaces the TPU kernel repro/kernels/fused_ce.py:_kernel (launched by
// fused_ce_forward).  There the grid is (token block x vocab block), run in
// order on one core, and the online-logsumexp state (running max m, running
// sum l, gold logit g) is carried across the vocab axis in VMEM scratch.
// Blocks on the card run in parallel and in no order, so the vocab axis is
// split instead:
//
//   fused_ce_partial_kernel  one block = 64 tokens x one vocab range (a
//                            "split"); it loops over 64-column vocab tiles of
//                            its range, each tile's logits computed in f32 from
//                            32-deep slabs of h and w staged in shared memory,
//                            and folds them into (m, l, g) per token; it writes
//                            those partials, 3 floats per (split, token);
//   fused_ce_combine_kernel  one thread per token merges its splits:
//                            M = max m, L = sum l * exp(m - M), G = sum g,
//                            loss = M + log(max(L, 1e-30)) - G.
//
// The gold logit is taken by comparing the column index with the label, as
// the TPU kernel does, never by a gather: a label outside [0, V) gives g = 0
// and never an illegal address.
//
// Bound: operations.  2*T*D*V multiply-adds against reading h and w once; at
// the LM head's shapes that is thousands of operations per byte, far above
// the card's balance.  The least time is the work at the bf16 tensor-core
// peak.  This first kernel multiplies with FFMA from shared-memory tiles
// (4x4 outputs per thread), so it sits far below that bound: the tensor
// cores (wgmma, TMA-fed tiles) are later work.  The products are exact in
// f32 for bf16 inputs; only the sum order over D differs from a library GEMM.
//
// Ragged edges are masked: a token row past T loads zeros and is never
// written; a vocab column past the split or V is left out of the max, the
// sum and the gold test.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TB = 64;        // tokens per block
constexpr int VB = 64;        // vocab columns per tile
constexpr int KB = 32;        // depth of one staged slab of D
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 logits each
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename in_t>
__global__ void __launch_bounds__(THREADS) fused_ce_partial_kernel(
    const in_t* __restrict__ h, const in_t* __restrict__ w,
    const int* __restrict__ labels, int T, int D, int V, int v_per_split,
    float* __restrict__ part) {
  // slabs: hs[k][t] = h[t0 + t, k0 + k], ws[k][v] = w[k0 + k, v0 + v]; rows
  // padded to 68 floats (272 bytes) keep float4 reads aligned
  __shared__ __align__(16) float hs[KB][TB + 4];
  __shared__ __align__(16) float ws[KB][VB + 4];
  __shared__ float tile[TB][VB + 1];
  __shared__ float m_s[TB], l_s[TB], g_s[TB];
  __shared__ int lab_s[TB];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int t0 = blockIdx.x * TB;
  const int split = blockIdx.y;
  const int n_split = gridDim.y;
  const int vbeg = split * v_per_split;
  const int vend = min(V, vbeg + v_per_split);

  if (tid < TB) {
    m_s[tid] = NEG;
    l_s[tid] = 0.f;
    g_s[tid] = 0.f;
    lab_s[tid] = t0 + tid < T ? labels[t0 + tid] : -1;
  }
  __syncthreads();

  for (int v0 = vbeg; v0 < vend; v0 += VB) {
    float acc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

    for (int k0 = 0; k0 < D; k0 += KB) {
      // h slab: consecutive threads read consecutive k of one token row
      for (int i = tid; i < TB * KB; i += THREADS) {
        const int t = i / KB, k = i % KB;
        float x = 0.f;
        if (t0 + t < T && k0 + k < D)
          x = to_f32(h[static_cast<size_t>(t0 + t) * D + k0 + k]);
        hs[k][t] = x;
      }
      // w slab: consecutive threads read consecutive vocab columns
      for (int i = tid; i < KB * VB; i += THREADS) {
        const int k = i / VB, v = i % VB;
        float x = 0.f;
        if (k0 + k < D && v0 + v < vend)
          x = to_f32(w[static_cast<size_t>(k0 + k) * V + v0 + v]);
        ws[k][v] = x;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < KB; ++k) {
        const float4 a = *reinterpret_cast<const float4*>(&hs[k][ty * 4]);
        const float4 b = *reinterpret_cast<const float4*>(&ws[k][tx * 4]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
      }
      __syncthreads();
    }

#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) tile[ty * 4 + r][tx * 4 + c] = acc[r][c];
    __syncthreads();

    // fold the tile into (m, l, g): four neighbouring lanes share a row,
    // 16 columns each, and reduce by shuffles
    {
      const int row = tid / 4, q = tid % 4;
      const int lab = lab_s[row];
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = q * 16 + j;
        if (v0 + col < vend) mx = fmaxf(mx, tile[row][col]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_old = m_s[row];
      const float m_new = fmaxf(m_old, mx);
      float s = 0.f, gold = 0.f;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = q * 16 + j;
        if (v0 + col < vend) {
          const float x = tile[row][col];
          s += expf(x - m_new);
          if (v0 + col == lab) gold += x;
        }
      }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      gold += __shfl_xor_sync(0xffffffffu, gold, 1);
      gold += __shfl_xor_sync(0xffffffffu, gold, 2);
      __syncwarp();
      if (q == 0) {
        l_s[row] = l_s[row] * expf(m_old - m_new) + s;
        m_s[row] = m_new;
        g_s[row] += gold;
      }
    }
    __syncthreads();
  }

  if (tid < TB && t0 + tid < T) {
    const size_t at = static_cast<size_t>(split) * T + t0 + tid;
    const size_t plane = static_cast<size_t>(n_split) * T;
    part[at] = m_s[tid];
    part[plane + at] = l_s[tid];
    part[2 * plane + at] = g_s[tid];
  }
}

__global__ void fused_ce_combine_kernel(const float* __restrict__ part,
                                        int T, int n_split,
                                        float* __restrict__ loss) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= T) return;
  const size_t plane = static_cast<size_t>(n_split) * T;
  float M = NEG;
  for (int s = 0; s < n_split; ++s)
    M = fmaxf(M, part[static_cast<size_t>(s) * T + t]);
  float L = 0.f, G = 0.f;
  for (int s = 0; s < n_split; ++s) {
    const size_t at = static_cast<size_t>(s) * T + t;
    L += part[plane + at] * expf(part[at] - M);
    G += part[2 * plane + at];
  }
  loss[t] = M + logf(fmaxf(L, 1e-30f)) - G;
}

template <typename in_t>
int launch(const void* h, const void* w, const int* labels, int T, int D,
           int V, int v_per_split, int n_split, float* part, float* loss,
           cudaStream_t stream) {
  const dim3 grid((T + TB - 1) / TB, n_split);
  fused_ce_partial_kernel<in_t><<<grid, THREADS, 0, stream>>>(
      static_cast<const in_t*>(h), static_cast<const in_t*>(w), labels, T, D,
      V, v_per_split, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_ce_combine_kernel<<<(T + 255) / 256, 256, 0, stream>>>(part, T,
                                                               n_split, loss);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype 0: float h and w; 1: bfloat16.  part holds 3 * n_split * T floats;
// returns cudaGetLastError() after each launch (0 when both were accepted).
extern "C" int fused_ce_launch(int dtype, const void* h, const void* w,
                               const void* labels, int T, int D, int V,
                               int v_per_split, int n_split, void* part,
                               void* loss, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* lab = static_cast<const int*>(labels);
  float* p = static_cast<float*>(part);
  float* out = static_cast<float*>(loss);
  if (dtype == 0)
    return launch<float>(h, w, lab, T, D, V, v_per_split, n_split, p, out, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(h, w, lab, T, D, V, v_per_split, n_split, p,
                                 out, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* fused_ce_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
