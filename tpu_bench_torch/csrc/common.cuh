// Helpers shared by the port's kernels.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace tbt {

// Four consecutive values from 16-byte aligned shared memory in 16-byte
// loads: one for float, two for double.
__device__ __forceinline__ void load4(const float* p, float* r) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    r[0] = q.x;
    r[1] = q.y;
    r[2] = q.z;
    r[3] = q.w;
}

__device__ __forceinline__ void load4(const double* p, double* r) {
    const double2 a = *reinterpret_cast<const double2*>(p);
    const double2 b = *reinterpret_cast<const double2*>(p + 2);
    r[0] = a.x;
    r[1] = a.y;
    r[2] = b.x;
    r[3] = b.y;
}

// The 16-byte vector of a type: four floats or two doubles.
template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
    using type = float4;
    static constexpr int width = 4;
};
template <>
struct Vec16<double> {
    using type = double2;
    static constexpr int width = 2;
};

// Elements of p[0:n] before the first 16-byte boundary at or after p: the
// scalar head of a vector loop (0 when p is aligned).  Tensors are aligned
// to their element size, so the count is exact.
template <typename T>
__host__ __device__ __forceinline__ long long head_elems(const T* p,
                                                         long long n) {
    const unsigned mis = reinterpret_cast<uintptr_t>(p) & 15u;
    const long long h = mis ? (16 - mis) / sizeof(T) : 0;
    return h < n ? h : n;
}

__host__ __device__ __forceinline__ bool aligned16(const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// f applied lane by lane to one or two 16-byte vectors.
template <typename F>
__device__ __forceinline__ float4 map_lanes(F f, float4 a, float4 b) {
    return make_float4(f(a.x, b.x), f(a.y, b.y), f(a.z, b.z), f(a.w, b.w));
}

template <typename F>
__device__ __forceinline__ double2 map_lanes(F f, double2 a, double2 b) {
    return make_double2(f(a.x, b.x), f(a.y, b.y));
}

// Sum over the lanes of f(lane, c).
template <typename F>
__device__ __forceinline__ float fold_lanes(F f, float4 a, float c) {
    return (f(a.x, c) + f(a.y, c)) + (f(a.z, c) + f(a.w, c));
}

template <typename F>
__device__ __forceinline__ double fold_lanes(F f, double2 a, double c) {
    return f(a.x, c) + f(a.y, c);
}

// acc + the lane-wise dot product of a and b.
__device__ __forceinline__ float dot_lanes(float4 a, float4 b, float acc) {
    acc = fma(a.x, b.x, acc);
    acc = fma(a.y, b.y, acc);
    acc = fma(a.z, b.z, acc);
    return fma(a.w, b.w, acc);
}

__device__ __forceinline__ double dot_lanes(double2 a, double2 b,
                                            double acc) {
    acc = fma(a.x, b.x, acc);
    return fma(a.y, b.y, acc);
}

// Sum of v over the 32 lanes of a warp, in lane 0.
template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
    for (int offset = 16; offset > 0; offset >>= 1)
        v += __shfl_down_sync(0xffffffffu, v, offset);
    return v;
}

}  // namespace tbt
