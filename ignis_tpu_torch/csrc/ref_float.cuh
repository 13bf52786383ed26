// How the JAX package's traversal kernels compare floats, for the CUDA
// kernels of the port (`ops/ref_float.py` is the same rule in PyTorch).
//
// Subnormals.  XLA on the CPU flushes subnormal floats to zero and a TPU has
// none, so where a JAX kernel tests a float against 0 (a direction component
// before its reciprocal, the Moeller-Trumbore determinant, the Baldwin-Weber
// k) a subnormal counts as 0.  The port keeps subnormals in its arithmetic
// (no -ftz: the plain versions run in eager PyTorch, which does not flush) and
// makes only those tests see them as 0: |x| < FLT_MIN.
//
// NaN.  A JAX slab test takes its minima and maxima with `jnp.minimum` /
// `jnp.maximum`, which keep NaN, so a NaN anywhere in a box's chain makes
// near <= far false and the box is rejected.  `nan_min` / `nan_max` are those
// operations (PTX `min.NaN` / `max.NaN`, sm_80 and later); `fminf` / `fmaxf`
// would drop the NaN and let the box pass.

#pragma once

#include <cuda_runtime.h>

namespace ignis {

constexpr float kFltMin = 1.17549435082228750797e-38f;   // smallest normal float

// x counts as 0 for the reference: zero or subnormal (NaN does not).
__device__ __forceinline__ bool is_zero(float x) { return fabsf(x) < kFltMin; }

// 1/x with the reference's guard: 1e30 for a component that counts as 0.
__device__ __forceinline__ float safe_inv(float x) { return is_zero(x) ? 1e30f : 1.0f / x; }

// min / max that return NaN when either operand is NaN.
__device__ __forceinline__ float nan_min(float a, float b) {
    float r;
    asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
    return r;
}

__device__ __forceinline__ float nan_max(float a, float b) {
    float r;
    asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
    return r;
}

}  // namespace ignis
