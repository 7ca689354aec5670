// Helpers shared by the port's kernels.
#pragma once

#include <cuda_runtime.h>

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

}  // namespace tbt
