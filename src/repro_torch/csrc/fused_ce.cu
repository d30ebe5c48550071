// Fused cross-entropy forward on Hopper: per-token loss lse(h @ w) - (h @ w)[label]
// without the (T, V) logits ever reaching device memory.
//
// Replaces the TPU kernel repro/kernels/fused_ce.py:_kernel (launched by
// fused_ce_forward).  There the grid is (token block x vocab block), run in
// order on one core, and the online-logsumexp state (running max m, running
// sum l, gold logit g) is carried across the vocab axis in VMEM scratch.
// Blocks on the card run in parallel and in no order, so the vocab axis is
// split instead: one block takes a token tile and one vocab range (a
// "split"), folds the logits of its range into (m, l, g) per token and
// writes those partials, 3 floats per (split, token); then
// fused_ce_combine_kernel, one thread per token, merges the splits:
// M = max m, L = sum l * exp(m - M), G = sum g, loss = M + log(max(L, 1e-30)) - G.
//
// Three partial kernels; the wrapper (kernels/fused_ce.py: variant) picks one
// from dtype, shapes and pointer alignment before launch:
//
//   fused_ce_wgmma_kernel   bf16 operands that TMA can describe (base
//                           pointers 16-byte aligned, rows of h and w a
//                           multiple of 16 bytes): wgmma.m64n256k16, w read
//                           MN-major through B's transpose flag;
//   fused_ce_tf32x3_kernel  every float32 input: 3xTF32 on the tensor cores,
//                           fed by tf32_split_kernel, a pre-pass (below);
//   fused_ce_partial_kernel bf16 that TMA cannot describe (V = 100 gives
//                           200-byte rows): 64 x 64 tiles, FFMA from 32-deep
//                           slabs staged in shared memory.
//
// Bound: operations.  2*T*D*V multiply-adds against reading h and w once; at
// the LM head's shapes that is thousands of operations per byte, far above
// the card's balance, so the least time is the work at the tensor-core peak,
// which only wgmma fed from shared memory reaches.
//
// 3xTF32.  TF32 keeps 10 mantissa bits, so one pass loses float32's digits.
// tf32_split_kernel splits each float x into hi = rna_tf32(x) and lo =
// rna_tf32(x - hi): float bit patterns whose low 13 bits are zero, exact
// TF32 values, so it does not matter whether the tensor core truncates or
// rounds its inputs; |x - hi - lo| <= 2^-22 |x|.  The kernel accumulates
// hi*lo, lo*hi, then hi*hi per k8 step; the dropped lo*lo is below 2^-22 of
// the product.  Three passes at 494.5 TFLOP/s take 27.09 ms at the qwen2-7b
// head, against 66.6 ms for one pass of FFMA at the 67 TFLOP/s of the CUDA
// cores.  wgmma takes transpose flags only for 16-bit types: for tf32 both A
// and B must be K-major in shared memory.  h (T, D) is; w (D, V) is not.  So
// the pre-pass writes w's parts transposed, (V, Dp) with D contiguous, and
// h's as (T, Dp); Dp is D rounded up to 4 (16-byte rows for TMA),
// zero-padded.  One pass over h and w: 6.72 GB moved at full width (2.00 ms
// at 3.35 TB/s) and 4.4 GB of transient memory.  Transposing each w slab in
// shared memory instead would repeat the work once per token tile (32 times
// at full width) at the cost of shared-memory bandwidth.
//
// The tensor cores truncate as they accumulate: each wgmma adds its products
// to the accumulator and drops the bits below the result's last place, so
// the error of a sum grows with the number of wgmma that feed it, in one
// direction.  Three passes at D = 3584 are 1,344 of them per logit, and
// with one sum per tile the loss lands 1.7e-5 of its largest value off the
// float64 loss, past the 1e-5 the kernel is held to (bf16's 224 stay near
// 3e-6).  So the tf32x3 kernel moves the tensor cores' sum into a second
// register sum with round-to-nearest adds every FLUSH = 8 slabs (K = 128)
// and restarts it at zero (7e-7).  Both sums need registers: a tile is 128
// tokens x 192 vocab columns, 96 + 96 registers a thread where bf16's
// 64 x 256 logits take 128 (128 columns would move a third more bytes per
// operation from L2).  A flush waits for its warpgroup's wgmma to drain, so
// the two warpgroups flush half a period apart.  chip_smoke.py
// --tf32-sweep times other flush periods and ring depths: the period moves
// the error, not the time.
//
// The two tensor-core kernels share one pipeline (tc_partials), and differ
// only in their boxes, descriptors, inner products and that flush (Bf16Op,
// Tf32x3Op):
//
//   * a block is 384 threads: two consumer warpgroups of 64 token rows each
//     (wgmma's M) and one producer warpgroup, of which one thread issues
//     the loads; setmaxnreg moves registers from the producer (40 a
//     thread) to the consumers (232), whose sums take 128 (bf16) or 192;
//   * the producer keeps a ring of 4 slabs in dynamic shared memory full,
//     loaded by TMA (cp.async.bulk.tensor); each stage has a "full" mbarrier
//     (the TMA bytes) and an "empty" one (one arrival per consumer warp once
//     its wgmma has read the slab).  TMA fills the ragged edges of T, D and
//     V with zeros, so the main loop has no masks.  bf16: 48 KB slabs, the
//     128 x 64 box of h and four 64 x 64 boxes of w (64 vocab columns a
//     box: the 128-byte swizzle spans 64 bf16).  tf32x3: 40 KB slabs, a
//     128 x 16 box of h_hi and of h_lo and a 192 x 16 box of w_hi and of
//     w_lo (the 64-byte swizzle spans 16 floats).  Why K = 16: hi and lo
//     double a slab's bytes per unit of depth; at K = 32 (the 128-byte
//     swizzle) only two 80 KB slabs would fit.  Four stages beat three and
//     five in --tf32-sweep;
//   * each consumer warpgroup keeps its 64 x N f32 sum in N / 2 registers a
//     thread.  bf16 (N = 256): wgmma.m64n256k16 four times per slab; h is
//     K-major (A plain), w is (D, V) with V contiguous, so B is MN-major:
//     the transpose flag for B and an MN-major 128-byte-swizzle descriptor,
//     whose leading byte offset steps between 64-column boxes (8 KB) and
//     whose stride byte offset between groups of 8 k-rows (1 KB).  tf32x3
//     (N = 192): per k8 step three wgmma.m64n192k8.f32.tf32.tf32 (hi*lo,
//     lo*hi, hi*hi: the small products first), two steps per slab; both
//     operands K-major with the 64-byte swizzle: a k8 step is 32 bytes along
//     each 64-byte row, 8-row groups lie 512 bytes apart.  One wgmma group
//     stays in flight while the next slab is awaited;
//   * after each N-column tile every thread folds the logits it holds
//     straight into its (m, l, g): the accumulator of m64nN gives a thread
//     rows 16*warp + lane/4 and that row + 8, columns 8*j + 2*(lane%4) +
//     {0, 1}; the row max is reduced over the lane quad by shuffles, each
//     lane keeps its own share of l and g (rescaled by the shared max), and
//     the quad sums them once at the end.  No logits tile goes to shared
//     memory.
//
// The products of bf16 inputs, and of TF32 parts, are exact in f32; only
// the order of the f32 sum over D (and, for float32, the split's 2^-22
// residue) differs from the plain version.  The gold logit is taken by
// comparing the column index with the label, never by a gather: a label
// outside [0, V) gives g = 0 and never an illegal address.  Columns at or
// past the split's end are left out of the max, the sum and the gold test;
// token rows past T are never written.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

namespace {

constexpr float NEG = -1e30f;

// ---- the FFMA kernel: bf16 that TMA cannot describe ------------------------

constexpr int TB = 64;        // tokens per block
constexpr int VB = 64;        // vocab columns per tile
constexpr int KB = 32;        // depth of one staged slab of D
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 logits each

__global__ void __launch_bounds__(THREADS) fused_ce_partial_kernel(
    const __nv_bfloat16* __restrict__ h, const __nv_bfloat16* __restrict__ w,
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
          x = __bfloat162float(h[static_cast<size_t>(t0 + t) * D + k0 + k]);
        hs[k][t] = x;
      }
      // w slab: consecutive threads read consecutive vocab columns
      for (int i = tid; i < KB * VB; i += THREADS) {
        const int k = i / VB, v = i % VB;
        float x = 0.f;
        if (k0 + k < D && v0 + v < vend)
          x = __bfloat162float(w[static_cast<size_t>(k0 + k) * V + v0 + v]);
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

// ---- the 3xTF32 pre-pass ---------------------------------------------------

constexpr int SPLIT_TILE = 32;     // a block splits a 32 x 32 tile
constexpr int SPLIT_THREADS = 256;  // 32 x 8: four elements a thread

// x rounded to TF32, to nearest with ties away from zero; the mask keeps
// the low 13 bits zero whatever cvt leaves there
__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return __uint_as_float(r & 0xffffe000u);
}

// x (rows, cols) row-major -> hi and lo, each (rows, cp) with cp = cols
// rounded up to 4, or with transpose (cols, rp), rp = rows rounded up to 4:
// out[c][r] = part(x[r][c]).  Padding is written as zeros.  A block reads
// its tile along x's rows and writes it along the output's, so both sides
// are coalesced; a non-finite x gives hi = x, lo = 0.
__global__ void __launch_bounds__(SPLIT_THREADS) tf32_split_kernel(
    const float* __restrict__ x, int rows, int cols, int transpose,
    float* __restrict__ hi, float* __restrict__ lo) {
  __shared__ float hs[SPLIT_TILE][SPLIT_TILE + 1];
  __shared__ float ls[SPLIT_TILE][SPLIT_TILE + 1];
  const int r0 = blockIdx.x * SPLIT_TILE, c0 = blockIdx.y * SPLIT_TILE;
  const int tx = threadIdx.x % SPLIT_TILE, ty = threadIdx.x / SPLIT_TILE;
  constexpr int STEP = SPLIT_THREADS / SPLIT_TILE;
  for (int i = ty; i < SPLIT_TILE; i += STEP) {
    const int r = r0 + i, c = c0 + tx;
    float a = 0.f, b = 0.f;
    if (r < rows && c < cols) {
      const float v = x[static_cast<size_t>(r) * cols + c];
      a = tf32_rna(v);
      b = isfinite(v) ? tf32_rna(v - a) : 0.f;
    }
    hs[i][tx] = a;
    ls[i][tx] = b;
  }
  __syncthreads();
  if (transpose) {
    const int rp = (rows + 3) & ~3;
    for (int i = ty; i < SPLIT_TILE; i += STEP) {
      const int c = c0 + i, r = r0 + tx;
      if (c < cols && r < rp) {
        const size_t at = static_cast<size_t>(c) * rp + r;
        hi[at] = hs[tx][i];
        lo[at] = ls[tx][i];
      }
    }
  } else {
    const int cp = (cols + 3) & ~3;
    for (int i = ty; i < SPLIT_TILE; i += STEP) {
      const int r = r0 + i, c = c0 + tx;
      if (r < rows && c < cp) {
        const size_t at = static_cast<size_t>(r) * cp + c;
        hi[at] = hs[i][tx];
        lo[at] = ls[i][tx];
      }
    }
  }
}

// ---- the tensor-core kernels -----------------------------------------------

constexpr int WG_TB = 128;     // tokens per block: two warpgroups of 64 rows
constexpr int WG_THREADS = 384;  // two consumer warpgroups + one producer
constexpr int MAX_SMEM = 232448;  // dynamic shared memory a block may use
constexpr float LOG2E = 1.4426950408889634f;
// descriptor layout types
constexpr uint64_t SWIZZLE_128B = 1, SWIZZLE_64B = 2;

// the tensor maps of one launch: bf16 uses h and w; tf32x3 h_hi, h_lo,
// w_hi, w_lo
struct Maps {
  CUtensorMap m[4];
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// returns once the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// 2-D TMA load of one box at (c0 innermost, c1) into shared memory,
// completing on an mbarrier; out-of-bounds elements arrive as zeros
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// shared-memory matrix descriptor; offsets in bytes
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma that owns the registers
template <int NR>
__device__ __forceinline__ void fence_acc(float (&d)[NR]) {
#pragma unroll
  for (int i = 0; i < NR; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// the f32 accumulator of one wgmma: 64 x 256 in operands %0-%127, 64 x 192
// in %0-%95
#define ACC128_REGS                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "   \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "   \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "   \
  "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "   \
  "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "   \
  "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "   \
  "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "       \
  "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, "       \
  "%122, %123, %124, %125, %126, %127}"
#define ACC128_OPERANDS(d)                                                   \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),    \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),           \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),       \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),       \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),       \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),       \
      "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),       \
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),       \
      "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),       \
      "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),       \
      "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),       \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),       \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),       \
      "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]),       \
      "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),       \
      "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]),       \
      "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]),       \
      "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),       \
      "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),       \
      "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]),      \
      "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]),  \
      "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]),  \
      "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),  \
      "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]),  \
      "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),  \
      "+f"(d[126]), "+f"(d[127])
#define ACC96_REGS                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "   \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "   \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "   \
  "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "   \
  "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "   \
  "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95}"
#define ACC96_OPERANDS(d)                                                  \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),  \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),         \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),     \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),     \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),     \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),     \
      "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),     \
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),     \
      "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),     \
      "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),     \
      "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),     \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),     \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),     \
      "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]),     \
      "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),     \
      "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]),     \
      "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]),     \
      "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),     \
      "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])

// d (64 x 256, f32) += A (64 x 16, K-major) * B (16 x 256, MN-major): the
// scale-d predicate is set (accumulate), B's transpose flag too
__device__ __forceinline__ void wgmma_bf16(float (&d)[128], uint64_t a,
                                           uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " ACC128_REGS
      ", %128, %129, p, 1, 1, 0, 1;\n"
      "}\n"
      : ACC128_OPERANDS(d)
      : "l"(a), "l"(b), "r"(1));
}

// d (64 x 192, f32) += A (64 x 8, K-major) * B (8 x 192, K-major) in TF32:
// no transpose flags exist for tf32, both operands are K-major
__device__ __forceinline__ void wgmma_tf32(float (&d)[96], uint64_t a,
                                           uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k8.f32.tf32.tf32 " ACC96_REGS
      ", %96, %97, p, 1, 1;\n"
      "}\n"
      : ACC96_OPERANDS(d)
      : "l"(a), "l"(b), "r"(1));
}

// bf16 h (T, D) and w (D, V): a slab is the 128 x 64 box of h (16 KB) and
// four 64 x 64 boxes of w (8 KB each), 128-byte swizzle
struct Bf16Op {
  static constexpr int N = 256;    // vocab columns per tile: wgmma's N
  static constexpr int KB = 64;    // 64 bf16 = one 128-byte row
  static constexpr int STAGES = 4;
  static constexpr int FLUSH = 0;  // one pass: the sum stays in the wgmma
  static constexpr int MAPS = 2;
  static constexpr int A_BYTES = WG_TB * KB * 2;
  static constexpr int BOX_V = 64;
  static constexpr int BOX_BYTES = KB * BOX_V * 2;
  static constexpr int STAGE_BYTES = A_BYTES + (N / BOX_V) * BOX_BYTES;

  static __device__ __forceinline__ void load(uint32_t slab, const Maps& maps,
                                              uint32_t bar, int k0, int t0,
                                              int v0) {
    tma_load(slab, &maps.m[0], bar, k0, t0);
#pragma unroll
    for (int j = 0; j < N / BOX_V; ++j)
      tma_load(slab + A_BYTES + j * BOX_BYTES, &maps.m[1], bar, v0 + j * BOX_V,
               k0);
  }

  static __device__ __forceinline__ void mma(float (&d)[128], uint32_t slab,
                                             int wg) {
    const uint32_t a = slab + wg * (64 * 128);
    const uint32_t b = slab + A_BYTES;
#pragma unroll
    for (int kk = 0; kk < KB / 16; ++kk) {
      // A: 16 k-columns are 32 bytes along each 128-byte row; rows step by
      // 128 bytes, 8-row groups by 1024 (the leading offset is unused)
      // B: 16 k-rows are 2048 bytes; 64-column boxes lie 8 KB apart
      // (leading offset), 8-row groups 1 KB apart (stride offset)
      wgmma_bf16(d, gmma_desc(a + kk * 32, 16, 1024, SWIZZLE_128B),
                 gmma_desc(b + kk * 2048, BOX_BYTES, 1024, SWIZZLE_128B));
    }
  }
};

// TF32 parts h_hi, h_lo (T, Dp) and w_hi, w_lo (V, Dp), all K-major: a slab
// is a 128 x 16 box of each h part (8 KB) and a 192 x 16 box of each w part
// (12 KB), 64-byte swizzle; the sum is flushed (see the header)
struct Tf32x3Op {
  static constexpr int N = 192;    // vocab columns per tile
  static constexpr int KB = 16;    // 16 floats = one 64-byte row
  static constexpr int STAGES = 4;
  static constexpr int FLUSH = 8;  // slabs between flushes (K = 128)
  static constexpr int MAPS = 4;
  static constexpr int H_BYTES = WG_TB * KB * 4;
  static constexpr int W_BYTES = N * KB * 4;
  static constexpr int STAGE_BYTES = 2 * H_BYTES + 2 * W_BYTES;

  static __device__ __forceinline__ void load(uint32_t slab, const Maps& maps,
                                              uint32_t bar, int k0, int t0,
                                              int v0) {
    tma_load(slab, &maps.m[0], bar, k0, t0);
    tma_load(slab + H_BYTES, &maps.m[1], bar, k0, t0);
    tma_load(slab + 2 * H_BYTES, &maps.m[2], bar, k0, v0);
    tma_load(slab + 2 * H_BYTES + W_BYTES, &maps.m[3], bar, k0, v0);
  }

  static __device__ __forceinline__ void mma(float (&d)[96], uint32_t slab,
                                             int wg) {
    // warpgroup wg reads rows 64 * wg.. of the h boxes (64 rows of 64 B)
    const uint32_t a_hi = slab + wg * (64 * 64), a_lo = a_hi + H_BYTES;
    const uint32_t b_hi = slab + 2 * H_BYTES, b_lo = b_hi + W_BYTES;
#pragma unroll
    for (int kk = 0; kk < KB / 8; ++kk) {
      // a k8 step is 32 bytes along each 64-byte row; 8-row groups lie 512
      // bytes apart (stride offset; the leading offset is unused)
      const uint32_t k = kk * 32;
      const uint64_t ah = gmma_desc(a_hi + k, 16, 512, SWIZZLE_64B);
      const uint64_t al = gmma_desc(a_lo + k, 16, 512, SWIZZLE_64B);
      const uint64_t bh = gmma_desc(b_hi + k, 16, 512, SWIZZLE_64B);
      const uint64_t bl = gmma_desc(b_lo + k, 16, 512, SWIZZLE_64B);
      wgmma_tf32(d, ah, bl);
      wgmma_tf32(d, al, bh);
      wgmma_tf32(d, ah, bh);
    }
  }
};

// folds one tile of logits, x (64 x N over the warpgroup, N / 2 a thread),
// into the (m, l, g) of rows r0 and r0 + 8; cb is the thread's first column
template <int NR>
__device__ __forceinline__ void fold(const float (&x)[NR], int cb, int vend,
                                     int lab0, int lab1, float& m0, float& m1,
                                     float& l0, float& l1, float& g0,
                                     float& g1) {
  float mx0 = NEG, mx1 = NEG;
#pragma unroll
  for (int j = 0; j < NR / 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool ok = cb + 8 * j + e < vend;
      mx0 = ok ? fmaxf(mx0, x[4 * j + e]) : mx0;
      mx1 = ok ? fmaxf(mx1, x[4 * j + 2 + e]) : mx1;
    }
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);
  const float nb0 = n0 * LOG2E, nb1 = n1 * LOG2E;
  float s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int j = 0; j < NR / 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = cb + 8 * j + e;
      const bool ok = col < vend;
      const float x0 = x[4 * j + e], x1 = x[4 * j + 2 + e];
      s0 += ok ? exp2f(fmaf(x0, LOG2E, -nb0)) : 0.f;
      s1 += ok ? exp2f(fmaf(x1, LOG2E, -nb1)) : 0.f;
      g0 += ok && col == lab0 ? x0 : 0.f;
      g1 += ok && col == lab1 ? x1 : 0.f;
    }
  l0 = l0 * exp2f((m0 - n0) * LOG2E) + s0;
  l1 = l1 * exp2f((m1 - n1) * LOG2E) + s1;
  m0 = n0;
  m1 = n1;
}

// the pipeline both tensor-core kernels run (see the header)
template <typename Op>
__device__ __forceinline__ void tc_partials(const Maps& maps,
                                            const int* __restrict__ labels,
                                            int T, int D, int V,
                                            int v_per_split,
                                            float* __restrict__ part) {
  constexpr int NR = Op::N / 2;  // accumulator registers a thread
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[Op::STAGES], empty[Op::STAGES];

  const uint32_t raw = smem_u32(smem_raw);
  // the swizzle repeats every 1024 (128-byte) or 512 (64-byte) bytes; TMA
  // and the descriptors assume stages start on such a boundary
  const uint32_t ring = (raw + 1023u) & ~1023u;
  const int t0 = blockIdx.x * WG_TB;
  const int split = blockIdx.y;
  const int vbeg = split * v_per_split;
  const int vend = min(V, vbeg + v_per_split);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < Op::STAGES; ++s) {
      mbar_init(smem_u32(&full[s]), 1);      // the producer's expect_tx
      mbar_init(smem_u32(&empty[s]), 8);     // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();

  // one branch per role, never rejoined, so ptxas can honour setmaxnreg
  if (warp >= 8) {
    // ---- producer: one thread keeps the ring full --------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (warp == 8 && lane == 0) {
#pragma unroll
      for (int i = 0; i < Op::MAPS; ++i)
        asm volatile("prefetch.tensormap [%0];" ::"l"(
                         reinterpret_cast<uint64_t>(&maps.m[i]))
                     : "memory");
      int stage = 0;
      uint32_t phase = 0;
      for (int v0 = vbeg; v0 < vend; v0 += Op::N) {
        for (int k0 = 0; k0 < D; k0 += Op::KB) {
          mbar_wait(smem_u32(&empty[stage]), phase ^ 1);
          const uint32_t bar = smem_u32(&full[stage]);
          mbar_expect_tx(bar, Op::STAGE_BYTES);
          Op::load(ring + stage * Op::STAGE_BYTES, maps, bar, k0, t0, v0);
          if (++stage == Op::STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns token rows 64 * wg .. 64 * wg + 63 ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
  const int wg = warp / 4;
  const int q = lane % 4;
  const int r0 = t0 + 64 * wg + 16 * (warp % 4) + lane / 4;  // and r0 + 8
  const int lab0 = r0 < T ? labels[r0] : -1;
  const int lab1 = r0 + 8 < T ? labels[r0 + 8] : -1;
  // tf32x3: the two warpgroups flush half a period apart, so one keeps the
  // tensor cores busy while the other drains its wgmma
  constexpr int PERIOD = Op::FLUSH > 0 ? Op::FLUSH : 1;
  const int flush_at = (PERIOD - 1 + wg * (PERIOD / 2)) % PERIOD;
  float m0 = NEG, m1 = NEG, l0 = 0.f, l1 = 0.f, g0 = 0.f, g1 = 0.f;
  float d[NR];                         // the tensor cores' sum
  float acc[Op::FLUSH > 0 ? NR : 1];   // tf32x3: the rounded sum of flushes
  int stage = 0;
  uint32_t phase = 0;

  for (int v0 = vbeg; v0 < vend; v0 += Op::N) {
#pragma unroll
    for (int i = 0; i < NR; ++i) d[i] = 0.f;
    if constexpr (Op::FLUSH > 0) {
#pragma unroll
      for (int i = 0; i < NR; ++i) acc[i] = 0.f;
    }
    int held = -1;  // the stage whose wgmma group may still be reading
    for (int k0 = 0, i = 0; k0 < D; k0 += Op::KB, ++i) {
      mbar_wait(smem_u32(&full[stage]), phase);
      fence_acc(d);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
      Op::mma(d, ring + stage * Op::STAGE_BYTES, wg);
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
      fence_acc(d);
      if (held >= 0 && lane == 0) mbar_arrive(smem_u32(&empty[held]));
      held = stage;
      if (++stage == Op::STAGES) {
        stage = 0;
        phase ^= 1;
      }
      if constexpr (Op::FLUSH > 0) {
        if (i % PERIOD == flush_at || k0 + Op::KB >= D) {
          // the tensor cores truncate as they accumulate: every FLUSH slabs
          // their sum moves into acc with round-to-nearest adds
          asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
          fence_acc(d);
#pragma unroll
          for (int j = 0; j < NR; ++j) {
            acc[j] += d[j];
            d[j] = 0.f;
          }
        }
      }
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    fence_acc(d);
    if (lane == 0) mbar_arrive(smem_u32(&empty[held]));

    if constexpr (Op::FLUSH > 0)
      fold(acc, v0 + 2 * q, vend, lab0, lab1, m0, m1, l0, l1, g0, g1);
    else
      fold(d, v0 + 2 * q, vend, lab0, lab1, m0, m1, l0, l1, g0, g1);
  }

  // the quad's lanes share m; their shares of l and g add up
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  g0 += __shfl_xor_sync(0xffffffffu, g0, 1);
  g0 += __shfl_xor_sync(0xffffffffu, g0, 2);
  g1 += __shfl_xor_sync(0xffffffffu, g1, 1);
  g1 += __shfl_xor_sync(0xffffffffu, g1, 2);
  if (q == 0) {
    const size_t plane = static_cast<size_t>(gridDim.y) * T;
    if (r0 < T) {
      const size_t at = static_cast<size_t>(split) * T + r0;
      part[at] = m0;
      part[plane + at] = l0;
      part[2 * plane + at] = g0;
    }
    if (r0 + 8 < T) {
      const size_t at = static_cast<size_t>(split) * T + r0 + 8;
      part[at] = m1;
      part[plane + at] = l1;
      part[2 * plane + at] = g1;
    }
  }
}

template <typename Op>
constexpr int ring_bytes() {
  constexpr int bytes = Op::STAGES * Op::STAGE_BYTES + 1024;  // + alignment
  static_assert(bytes <= MAX_SMEM, "the ring does not fit");
  return bytes;
}

__global__ void __launch_bounds__(WG_THREADS, 1) fused_ce_wgmma_kernel(
    const __grid_constant__ Maps maps, const int* __restrict__ labels, int T,
    int D, int V, int v_per_split, float* __restrict__ part) {
  tc_partials<Bf16Op>(maps, labels, T, D, V, v_per_split, part);
}

__global__ void __launch_bounds__(WG_THREADS, 1) fused_ce_tf32x3_kernel(
    const __grid_constant__ Maps maps, const int* __restrict__ labels, int T,
    int D, int V, int v_per_split, float* __restrict__ part) {
  tc_partials<Tf32x3Op>(maps, labels, T, D, V, v_per_split, part);
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

int combine(const float* part, int T, int n_split, float* loss,
            cudaStream_t stream) {
  fused_ce_combine_kernel<<<(T + 255) / 256, 256, 0, stream>>>(part, T,
                                                               n_split, loss);
  return static_cast<int>(cudaGetLastError());
}

// cuTensorMapEncodeTiled, taken from the driver through the runtime, so the
// library needs no link against libcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a row-major (rows, cols) bf16 or float matrix whose rows lie `pitch`
// elements apart, boxes of box_rows x box_cols; returns a CUresult
CUresult encode(EncodeTiled enc, CUtensorMap* map, bool is_float,
                const void* base, uint64_t rows, uint64_t cols, uint64_t pitch,
                uint32_t box_rows, uint32_t box_cols,
                CUtensorMapSwizzle swizzle) {
  const uint64_t size = is_float ? 4 : 2;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {pitch * size};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return enc(map,
             is_float ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                      : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
             2, const_cast<void*>(base), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// error codes of the launchers: cudaError_t values (> 0), or a CUresult of
// cuTensorMapEncodeTiled as -(code + 1)
int driver_code(CUresult res) { return -(static_cast<int>(res) + 1); }

using TcKernel = void (*)(const Maps, const int*, int, int, int, int, float*);

// sets the shared-memory limit of Op's kernel once per device, launches it
// and the combine
template <typename Op>
int tc_launch(TcKernel kernel, const Maps& maps, const void* labels, int T,
              int D, int V, int v_per_split, int n_split, void* part,
              void* loss, void* stream) {
  constexpr int smem = ring_bytes<Op>();
  static bool smem_set[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!smem_set[dev]) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set[dev] = true;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  const dim3 grid((T + WG_TB - 1) / WG_TB, n_split);
  kernel<<<grid, WG_THREADS, smem, s>>>(
      maps, static_cast<const int*>(labels), T, D, V, v_per_split, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return combine(p, T, n_split, static_cast<float*>(loss), s);
}

}  // namespace

// The FFMA kernel on bf16 h (T, D) and w (D, V), both contiguous.  part
// holds 3 * n_split * T floats; returns cudaGetLastError() after each launch
// (0 when both were accepted).
extern "C" int fused_ce_launch(const void* h, const void* w,
                               const void* labels, int T, int D, int V,
                               int v_per_split, int n_split, void* part,
                               void* loss, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  const dim3 grid((T + TB - 1) / TB, n_split);
  fused_ce_partial_kernel<<<grid, THREADS, 0, s>>>(
      static_cast<const __nv_bfloat16*>(h), static_cast<const __nv_bfloat16*>(w),
      static_cast<const int*>(labels), T, D, V, v_per_split, p);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return combine(p, T, n_split, static_cast<float*>(loss), s);
}

// The tensor-core kernel on bf16 h (T, D) and w (D, V), both contiguous with
// 16-byte aligned bases and D, V multiples of 8; v_per_split a multiple of
// 256.  Encodes the two tensor maps, launches it and the combine.  Returns
// 0, a cudaError_t, or -(CUresult + 1) when a tensor map is refused.
extern "C" int fused_ce_wgmma_launch(const void* h, const void* w,
                                     const void* labels, int T, int D, int V,
                                     int v_per_split, int n_split, void* part,
                                     void* loss, void* stream) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return driver_code(CUDA_ERROR_NOT_FOUND);
  Maps maps = {};
  CUresult res = encode(enc, &maps.m[0], false, h, T, D, D, WG_TB,
                        Bf16Op::KB, CU_TENSOR_MAP_SWIZZLE_128B);
  if (res != CUDA_SUCCESS) return driver_code(res);
  res = encode(enc, &maps.m[1], false, w, D, V, V, Bf16Op::KB, Bf16Op::BOX_V,
               CU_TENSOR_MAP_SWIZZLE_128B);
  if (res != CUDA_SUCCESS) return driver_code(res);
  return tc_launch<Bf16Op>(fused_ce_wgmma_kernel, maps, labels, T, D, V,
                           v_per_split, n_split, part, loss, stream);
}

// The 3xTF32 pre-pass on float x (rows, cols), contiguous: hi and lo each
// (rows, cp), or with transpose != 0 (cols, rp), cp and rp rounded up to 4
// (see tf32_split_kernel).  Returns cudaGetLastError() after the launch.
extern "C" int fused_ce_split_launch(const void* x, int rows, int cols,
                                     int transpose, void* hi, void* lo,
                                     void* stream) {
  const int rp = (rows + 3) & ~3, cp = (cols + 3) & ~3;
  const dim3 grid(((transpose ? rp : rows) + SPLIT_TILE - 1) / SPLIT_TILE,
                  ((transpose ? cols : cp) + SPLIT_TILE - 1) / SPLIT_TILE);
  tf32_split_kernel<<<grid, SPLIT_THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), rows, cols, transpose,
      static_cast<float*>(hi), static_cast<float*>(lo));
  return static_cast<int>(cudaGetLastError());
}

// The 3xTF32 kernel on the pre-pass's parts: h_hi, h_lo (T, dp) and w_hi,
// w_lo (V, dp), dp >= D a multiple of 4, 16-byte aligned bases;
// v_per_split a multiple of 192.  Encodes the four tensor maps (D columns:
// TMA zero-fills past D), launches it and the combine.  Returns as
// fused_ce_wgmma_launch.
extern "C" int fused_ce_tf32x3_launch(const void* h_hi, const void* h_lo,
                                      const void* w_hi, const void* w_lo,
                                      int dp, const void* labels, int T, int D,
                                      int V, int v_per_split, int n_split,
                                      void* part, void* loss, void* stream) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return driver_code(CUDA_ERROR_NOT_FOUND);
  Maps maps = {};
  const void* bases[4] = {h_hi, h_lo, w_hi, w_lo};
  for (int i = 0; i < 4; ++i) {
    const bool is_h = i < 2;
    const CUresult res = encode(enc, &maps.m[i], true, bases[i], is_h ? T : V,
                                D, dp, is_h ? WG_TB : Tf32x3Op::N,
                                Tf32x3Op::KB,
                                CU_TENSOR_MAP_SWIZZLE_64B);
    if (res != CUDA_SUCCESS) return driver_code(res);
  }
  return tc_launch<Tf32x3Op>(fused_ce_tf32x3_kernel, maps, labels, T, D, V,
                             v_per_split, n_split, part, loss, stream);
}

extern "C" const char* fused_ce_error(int code) {
  if (code >= 0) return cudaGetErrorString(static_cast<cudaError_t>(code));
  static thread_local char msg[96];
  snprintf(msg, sizeof msg,
           "cuTensorMapEncodeTiled or its entry point failed: CUresult %d",
           -code - 1);
  return msg;
}
