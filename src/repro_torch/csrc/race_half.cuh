// float16 and bfloat16 for the RACE stencil kernels that
// repro_torch/lowering/emit.py:render_cuda generates: included in place of
// race_stencil.cuh by a kernel of a half plan, so the float32 and float64
// kernels do not parse the half headers.
//
// A half element is stored at 2 bytes and computed in float: shared memory,
// registers and scalars hold float, so a half plan has the float32 plan's
// geometry.  An operand is converted to float as it is read, and every
// output is rounded once, to nearest even, as it is stored.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include "race_stencil.cuh"

__device__ __forceinline__ float race_acc(__half x) { return __half2float(x); }
__device__ __forceinline__ float race_acc(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void race_store(__half* p, float v) {
  *p = __float2half_rn(v);
}
__device__ __forceinline__ void race_store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// PTX's cp.async copies 4, 8 or 16 bytes, never 2.  A half kernel stages
// the first plane of its march by a guarded ordinary load, converted to
// float on its way into shared memory: each thread waits for its loads.
__device__ __forceinline__ void race_stage(float* dst, const __half* src,
                                           bool ok) {
  *dst = ok ? __half2float(*src) : 0.0f;
}
__device__ __forceinline__ void race_stage(float* dst,
                                           const __nv_bfloat16* src, bool ok) {
  *dst = ok ? __bfloat162float(*src) : 0.0f;
}

// Every later plane is loaded one step ahead into registers, raw, and
// written to shared memory (through race_acc) only after the step's body
// (emit.py:_next_plane): no instruction reads the loaded register before
// then, so the loads stay in flight while the step computes.  Zero when ok
// is false, and then nothing is read.
__device__ __forceinline__ __half race_fetch(const __half* src, bool ok) {
  return ok ? *src : __ushort_as_half(0);
}
__device__ __forceinline__ __nv_bfloat16 race_fetch(const __nv_bfloat16* src,
                                                    bool ok) {
  return ok ? *src : __ushort_as_bfloat16(0);
}
