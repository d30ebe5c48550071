// Shared support for the RACE stencil kernels that
// repro_torch/lowering/emit.py:render_cuda generates, one per plan.
//
// Replaces the TPU kernel repro/lowering/emit.py:build_kernel (its grid and
// windows: repro/lowering/blocks.py:build_layout; its in-kernel gather:
// repro/lowering/gather.py:gather_ref).
//
// Bound: device-memory bytes.  A stencil does a few operations per element
// it reads, far below the H100's balance, so the least time is the bytes
// that must move (each input read once, each output written once) over the
// card's memory rate.  float64 runs at a fraction of float32's rate on this
// card, but the kernel stays bound by memory at both widths.
//
// What the design does about it (a 2.5-D streaming kernel):
//   * a block owns a tile of the plane of every level but one and marches
//     along that stream level, one plane per step;
//   * every auxiliary array RACE materialises lives only in shared memory,
//     as a ring of planes over its exact one-sided range, and each of its
//     planes is evaluated once per step: no aux ever touches device memory
//     and none is recomputed in a halo of another tile's plane;
//   * each operand read at unit positive coefficients is staged one plane
//     window per step with cp.async (zero-filled outside the array), the
//     next steps' planes in flight while this step computes; other operands
//     (strided, mirrored, gathered) are read in place through affine
//     indices with guarded loads;
//   * outputs are written in their own dimension order: no transpose, flip,
//     pad or halo copy of any operand (the Pallas path made those on every
//     call to feed BlockSpec);
//   * every store is guarded to the statement extents.
#pragma once

#include <cuda_runtime.h>

// Kernel arguments, passed by value: operand and output base pointers and
// the small device array of scalars.
template <typename scalar_t, int NIN, int NOUT>
struct RaceArgs {
  const scalar_t* in[NIN];
  scalar_t* out[NOUT];
  const scalar_t* scalars;
};

// The IR's function calls, at the operand precision.
__device__ __forceinline__ float race_sin(float x) { return sinf(x); }
__device__ __forceinline__ double race_sin(double x) { return sin(x); }
__device__ __forceinline__ float race_cos(float x) { return cosf(x); }
__device__ __forceinline__ double race_cos(double x) { return cos(x); }
__device__ __forceinline__ float race_exp(float x) { return expf(x); }
__device__ __forceinline__ double race_exp(double x) { return exp(x); }
__device__ __forceinline__ float race_log(float x) { return logf(x); }
__device__ __forceinline__ double race_log(double x) { return log(x); }
__device__ __forceinline__ float race_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double race_sqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float race_tanh(float x) { return tanhf(x); }
__device__ __forceinline__ double race_tanh(double x) { return tanh(x); }
__device__ __forceinline__ float race_abs(float x) { return fabsf(x); }
__device__ __forceinline__ double race_abs(double x) { return fabs(x); }

// cp.async of one element into shared memory; with ok false, no byte is
// read from src and the element is zero-filled.
__device__ __forceinline__ void race_cp_async(float* dst, const float* src,
                                              bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void race_cp_async(double* dst, const double* src,
                                              bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 8 : 0)
               : "memory");
}
__device__ __forceinline__ void race_cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void race_cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

extern "C" const char* race_stencil_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
