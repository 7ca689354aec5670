// Helpers shared by the port's kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>

namespace tbt {

using bf16 = __nv_bfloat16;

// ---- Storage and accumulate types ----
//
// A kernel stores values in S and sums them in Acc<S>: f32 and f64 in
// themselves, bf16 in f32.  widen turns a stored value into its sum type
// (exactly); narrow<S> rounds a sum to S, to nearest even.

template <typename S>
struct AccOf {
    using type = S;
};
template <>
struct AccOf<bf16> {
    using type = float;
};
template <typename S>
using Acc = typename AccOf<S>::type;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ double widen(double v) { return v; }
__device__ __forceinline__ float widen(bf16 v) { return __bfloat162float(v); }

template <typename S>
__device__ __forceinline__ S narrow(Acc<S> v) {
    if constexpr (sizeof(S) == 2)
        return __float2bfloat16_rn(v);
    else
        return v;
}

// Two f32 values rounded to bf16 and packed into one 32-bit word, the
// first in the low half (the lower address).
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const unsigned*>(&h);
}

// The two bf16 halves of a word, widened (exactly) to f32.
__device__ __forceinline__ float bf16_lo(unsigned w) {
    return __uint_as_float(w << 16);
}

__device__ __forceinline__ float bf16_hi(unsigned w) {
    return __uint_as_float(w & 0xffff0000u);
}

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

// Four consecutive bf16 values, widened to f32, from 8-byte aligned memory
// in one 8-byte load.
__device__ __forceinline__ void load4(const bf16* p, float* r) {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    r[0] = bf16_lo(q.x);
    r[1] = bf16_hi(q.x);
    r[2] = bf16_lo(q.y);
    r[3] = bf16_hi(q.y);
}

// Four consecutive values to 16-byte aligned (shared or global) memory in
// 16-byte stores; four f32 rounded to bf16 to 8-byte aligned memory in one
// 8-byte store.
__device__ __forceinline__ void store4(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(double* p, const double* v) {
    *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
    *reinterpret_cast<double2*>(p + 2) = make_double2(v[2], v[3]);
}

__device__ __forceinline__ void store4(bf16* p, const float* v) {
    *reinterpret_cast<uint2*>(p) =
        make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
}

// The 16-byte vector of a type: four floats, two doubles or eight bf16.
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
template <>
struct Vec16<bf16> {
    using type = uint4;
    static constexpr int width = 8;
};

// One 16-byte vector (Vec16<T>::width values) from or to 16-byte aligned
// memory.
__device__ __forceinline__ void load16(const float* p, float* r) {
    load4(p, r);
}

__device__ __forceinline__ void load16(const double* p, double* r) {
    const double2 a = *reinterpret_cast<const double2*>(p);
    r[0] = a.x;
    r[1] = a.y;
}

__device__ __forceinline__ void store16(float* p, const float* v) {
    store4(p, v);
}

__device__ __forceinline__ void store16(double* p, const double* v) {
    *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
}

// Eight bf16, widened to f32 or rounded from it.
__device__ __forceinline__ void load16(const bf16* p, float* r) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        r[2 * i] = bf16_lo(w[i]);
        r[2 * i + 1] = bf16_hi(w[i]);
    }
}

__device__ __forceinline__ void store16(bf16* p, const float* v) {
    *reinterpret_cast<uint4*>(p) =
        make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                   pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
}

// W consecutive values (one 16-byte vector: W = 16 / sizeof(T); or W = 1,
// one value) from global memory by a plain load.
__device__ __forceinline__ void load_w(const float* p, float (&r)[4]) {
    load4(p, r);
}

__device__ __forceinline__ void load_w(const double* p, double (&r)[2]) {
    const double2 q = *reinterpret_cast<const double2*>(p);
    r[0] = q.x;
    r[1] = q.y;
}

template <typename T>
__device__ __forceinline__ void load_w(const T* p, T (&r)[1]) {
    r[0] = *p;
}

// bf16 values widened to f32: eight (one 16-byte vector) or one.
__device__ __forceinline__ void load_w(const bf16* p, float (&r)[8]) {
    load16(p, r);
}

__device__ __forceinline__ void load_w(const bf16* p, float (&r)[1]) {
    r[0] = widen(*p);
}

// The same W values to global memory that nothing reads again, with the
// streaming hint (st.global.cs: evict first), so they do not push out of
// L2 the lines that are read again.
__device__ __forceinline__ void store_cs(float* p, const float (&v)[4]) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
}

__device__ __forceinline__ void store_cs(double* p, const double (&v)[2]) {
    __stcs(reinterpret_cast<double2*>(p), make_double2(v[0], v[1]));
}

template <typename T>
__device__ __forceinline__ void store_cs(T* p, const T (&v)[1]) {
    __stcs(p, v[0]);
}

// f32 sums rounded to bf16: eight (one 16-byte vector) or one.
__device__ __forceinline__ void store_cs(bf16* p, const float (&v)[8]) {
    __stcs(reinterpret_cast<uint4*>(p),
           make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                      pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7])));
}

__device__ __forceinline__ void store_cs(bf16* p, const float (&v)[1]) {
    const bf16 h = __float2bfloat16_rn(v[0]);
    __stcs(reinterpret_cast<unsigned short*>(p),
           *reinterpret_cast<const unsigned short*>(&h));
}

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

// acc[v] += lane v of a times c.
__device__ __forceinline__ void fma_lanes(float4 a, float c, float* acc) {
    acc[0] = fma(a.x, c, acc[0]);
    acc[1] = fma(a.y, c, acc[1]);
    acc[2] = fma(a.z, c, acc[2]);
    acc[3] = fma(a.w, c, acc[3]);
}

__device__ __forceinline__ void fma_lanes(double2 a, double c, double* acc) {
    acc[0] = fma(a.x, c, acc[0]);
    acc[1] = fma(a.y, c, acc[1]);
}

// Sum of v over the 32 lanes of a warp, in lane 0.
template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
    for (int offset = 16; offset > 0; offset >>= 1)
        v += __shfl_down_sync(0xffffffffu, v, offset);
    return v;
}

// f(a, b, c) lane by lane on one or two 16-byte vectors; c is one scalar.
template <typename F>
__device__ __forceinline__ float4 map_lanes(F f, float4 a, float4 b,
                                            float c) {
    return make_float4(f(a.x, b.x, c), f(a.y, b.y, c), f(a.z, b.z, c),
                       f(a.w, b.w, c));
}

template <typename F>
__device__ __forceinline__ double2 map_lanes(F f, double2 a, double2 b,
                                             double c) {
    return make_double2(f(a.x, b.x, c), f(a.y, b.y, c));
}

// ---- Values a launcher computes once per device ----

// Up to SLOTS (device, key) -> value entries a launcher site fills on
// first use: a kernel instance's occupancy at a shared-memory size, or
// whether its shared-memory opt-in is set.  compute() returns the value,
// or a negative number that is not kept (an error, asked again next time);
// past SLOTS keys a value is computed on every call.
template <int SLOTS = 64>
class DeviceCache {
   public:
    template <typename F>
    long long get(long long key, F compute) {
        int dev = -1;
        if (cudaGetDevice(&dev) != cudaSuccess) return -1;
        {
            std::lock_guard<std::mutex> lock(mutex_);
            for (int i = 0; i < used_; ++i)
                if (dev_[i] == dev && key_[i] == key) return value_[i];
        }
        const long long value = compute(dev);
        if (value >= 0) {
            std::lock_guard<std::mutex> lock(mutex_);
            if (used_ < SLOTS) {
                dev_[used_] = dev;
                key_[used_] = key;
                value_[used_] = value;
                ++used_;
            }
        }
        return value;
    }

   private:
    std::mutex mutex_;
    int used_ = 0;
    int dev_[SLOTS] = {};
    long long key_[SLOTS] = {};
    long long value_[SLOTS] = {};
};

// Set `kernel`'s dynamic shared-memory opt-in to the most the device
// allows beside the kernel's static shared memory, once per device (cache:
// the launcher site's own); later launches of any size up to it need no
// call.
template <typename K>
inline cudaError_t optin_smem(DeviceCache<>& cache, K kernel) {
    const long long r = cache.get(0, [&](int dev) -> long long {
        int limit = 0;
        cudaFuncAttributes attr{};
        cudaError_t err = cudaDeviceGetAttribute(
            &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
        if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
        if (err == cudaSuccess)
            err = cudaFuncSetAttribute(
                kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                limit - static_cast<int>(attr.sharedSizeBytes));
        return err == cudaSuccess ? 0 : -static_cast<long long>(err);
    });
    return r < 0 ? static_cast<cudaError_t>(-r) : cudaSuccess;
}

// Blocks of `kernel` the device holds at once with `threads` threads and
// `smem` bytes of dynamic shared memory (the occupancy API's blocks an SM
// times the SMs), once per device and size; 0 if none fits, or minus a
// CUDA error code.
template <typename K>
inline long long wave_blocks(DeviceCache<>& cache, K kernel, int threads,
                             size_t smem) {
    return cache.get(static_cast<long long>(smem) * 4096 + threads,
                     [&](int dev) -> long long {
        int sms = 0, per_sm = 0;
        cudaError_t err = cudaDeviceGetAttribute(
            &sms, cudaDevAttrMultiProcessorCount, dev);
        if (err == cudaSuccess)
            err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &per_sm, kernel, threads, smem);
        return err == cudaSuccess ? static_cast<long long>(per_sm) * sms
                                  : -static_cast<long long>(err);
    });
}

// ---- Asynchronous copies and tensor-core fragments (sm_80 and later) ----

__device__ __forceinline__ unsigned smem_addr(const void* p) {
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// BYTES (4, 8 or 16) from global src to shared dst without passing through
// registers; with valid false nothing is read and dst is zero-filled.  src
// must be a readable address even then (the caller passes a base pointer).
// cp.async has no 2-byte form, so BYTES = 2 (one bf16 value a copy, on
// rows that are not whole 16-byte words) is a plain load and store, done
// before the call returns; the caller's wait and barrier cover it too.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool valid) {
    const int src_bytes = valid ? BYTES : 0;
    if constexpr (BYTES == 2)
        *static_cast<unsigned short*>(dst) =
            valid ? *static_cast<const unsigned short*>(src)
                  : static_cast<unsigned short>(0);
    else if constexpr (BYTES == 16)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                         smem_addr(dst)),
                     "l"(src), "r"(src_bytes));
    else
        asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                         smem_addr(dst)),
                     "l"(src), "n"(BYTES), "r"(src_bytes));
}

// The first `bytes` (0..16) of 16 bytes from global src to shared dst, the
// rest zero-filled: the ragged end of a flat span.  Both 16-byte aligned.
__device__ __forceinline__ void cp_async16_bytes(void* dst, const void* src,
                                                 int bytes) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

// rows x COLS values of a row-major global matrix (row stride ld_g), from
// (r0, c0), into shared memory of row stride ld_s by cp.async, the NTH
// threads of a block taking every NTH-th copy; zero past n_rows and
// n_cols.  vec: 16-byte copies, for rows of whole 16-byte words with c0 and
// COLS multiples of a word (so a word is wholly in or out); else one value
// a copy.
template <typename T, int COLS, int NTH>
__device__ __forceinline__ void copy_tile_async(
    T* dst, int ld_s, int rows, const T* __restrict__ src, long long ld_g,
    long long r0, long long c0, long long n_rows, long long n_cols,
    bool vec) {
    constexpr int V = 16 / sizeof(T);
    if (vec) {
        for (int q = threadIdx.x; q < rows * (COLS / V); q += NTH) {
            const int r = q / (COLS / V), c = (q % (COLS / V)) * V;
            const bool ok = r0 + r < n_rows && c0 + c < n_cols;
            cp_async<16>(dst + r * ld_s + c,
                         ok ? src + (r0 + r) * ld_g + c0 + c : src, ok);
        }
    } else {
        for (int q = threadIdx.x; q < rows * COLS; q += NTH) {
            const int r = q / COLS, c = q % COLS;
            const bool ok = r0 + r < n_rows && c0 + c < n_cols;
            cp_async<sizeof(T)>(dst + r * ld_s + c,
                                ok ? src + (r0 + r) * ld_g + c0 + c : src,
                                ok);
        }
    }
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8x8 b16 matrices from shared memory; lanes 8j..8j+7 give the row
// addresses of matrix j, and register j receives row lane/4, columns
// 2*(lane%4) and +1 of it (of its transpose with .trans).
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const void* p) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_addr(p)));
}

// d (16x8 f32) += a (16x16 bf16, row) @ b (16x8 bf16, col).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// a = big + small for 3xTF32: big is a rounded to TF32 (10 stored mantissa
// bits) to nearest, ties away, by adding half of the 13 dropped bits' range
// and clearing them; small = a - big exactly, whose low 13 bits the tensor
// cores ignore, which truncates it to TF32.  Two integer operations and a
// subtraction: on the H100 a split by cvt.rna.tf32.f32 cost more than the
// mma it feeds.  A NaN in a stays a NaN in small.
__device__ __forceinline__ void split_tf32(float a, unsigned& big,
                                           unsigned& small) {
    big = (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
    small = __float_as_uint(a - __uint_as_float(big));
}

// d (16x8 f32) += a (16x8 tf32, row) @ b (8x8 tf32, col).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d (8x8 f64) += a (8x4 f64, row) @ b (4x8 f64, col): IEEE FP64 FMA on the
// tensor cores (DMMA).
__device__ __forceinline__ void mma_f64(double (&d)[2], double a, double b) {
    asm("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, "
        "{%3}, {%0, %1};\n"
        : "+d"(d[0]), "+d"(d[1])
        : "d"(a), "d"(b));
}

// d (16x8 f64) += a (16x8 f64, row) @ b (8x8 f64, col): sm_90's DMMA
// shape, 1024 IEEE FP64 FMAs an instruction, at twice m8n8k4's rate per
// FMA on the H100 (scripts/dmma_probe.cu: 66.7 against 33.6 TFLOP/s).
// Lane 4g + t holds a[i] at (g + 8 (i % 2), t + 4 (i / 2)), b[i] at
// (t + 4i, g) and d[i] at (g + 8 (i / 2), 2t + i % 2).
__device__ __forceinline__ void mma_f64_16x8x8(double (&d)[4],
                                               const double (&a)[4],
                                               const double (&b)[2]) {
    asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
        : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

// ---- Bulk copies and mbarriers (sm_90) ----

// An mbarrier in shared memory expecting `count` arrivals a phase.
__device__ __forceinline__ void mbar_init(void* bar, unsigned count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                     smem_addr(bar)),
                 "r"(count)
                 : "memory");
}

// Make the barriers' initialisation visible to the async proxy.
__device__ __forceinline__ void mbar_init_fence() {
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival on bar that also expects `bytes` more of bulk copies to
// complete in this phase.
__device__ __forceinline__ void mbar_expect_tx(void* bar, unsigned bytes) {
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
            smem_addr(bar)),
        "r"(bytes)
        : "memory");
}

// Wait until the phase of bar with parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(void* bar, unsigned parity) {
    const unsigned addr = smem_addr(bar);
    unsigned done = 0;
    do {
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done)
            : "r"(addr), "r"(parity)
            : "memory");
    } while (!done);
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from global
// src to shared dst by the copy engine; completes bytes on bar.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, void* bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
        "l"(src), "r"(bytes), "r"(smem_addr(bar))
        : "memory");
}

// One box of a 3D tensor map (TMA) at coordinates (x, y, z), x fastest,
// into shared dst (128-byte aligned); completes the box's bytes on bar,
// zeros included for the parts past the tensor's ends.
__device__ __forceinline__ void tma_load_3d(void* dst, const void* map, int x,
                                            int y, int z, void* bar) {
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_"
        "tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
        "l"(map), "r"(smem_addr(bar)), "r"(x), "r"(y), "r"(z)
        : "memory");
}

// `bytes` from shared src to global dst by the copy engine, in the
// thread's current bulk group.
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           unsigned bytes) {
    asm volatile(
        "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
            dst),
        "r"(smem_addr(src)), "r"(bytes)
        : "memory");
}

__device__ __forceinline__ void bulk_commit() {
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Wait until at most N of the thread's bulk groups have not yet read
// their shared memory (the slots may then be refilled).
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
    asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// Wait until at most N of the thread's bulk groups are not yet complete.
template <int N>
__device__ __forceinline__ void bulk_wait() {
    asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// Order this thread's writes to shared memory before later bulk copies
// or wgmma (the async proxy) read it.
__device__ __forceinline__ void fence_async_shared() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// One arrival on bar, after this thread's earlier memory operations.
__device__ __forceinline__ void mbar_arrive(void* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                     smem_addr(bar))
                 : "memory");
}

// Wait at named barrier `id` for `count` threads (whole warps).
__device__ __forceinline__ void named_sync(int id, int count) {
    asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// ---- Warp-group mma (sm_90a) ----

// Set the executing warp group's registers a thread to N (all four warps
// together): dec hands registers back to the block's pool, inc takes them.
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// The wgmma descriptor of a K-major operand in shared memory without
// swizzle: core matrices of 8 rows of 16 bytes, the rows contiguous; lbo
// bytes between the two core matrices of a 32-byte k slice, sbo bytes
// between neighbouring groups of 8 rows.
__device__ __forceinline__ unsigned long long wgmma_desc(const void* p,
                                                         unsigned lbo,
                                                         unsigned sbo) {
    return static_cast<unsigned long long>((smem_addr(p) & 0x3FFFF) >> 4) |
           static_cast<unsigned long long>((lbo >> 4) & 0x3FFF) << 16 |
           static_cast<unsigned long long>((sbo >> 4) & 0x3FFF) << 32;
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N of the warp group's wgmma groups are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pin r in place: the compiler moves no access of it across this point (a
// wgmma reads and writes its registers after the instruction has issued,
// which the compiler cannot see).
__device__ __forceinline__ void reg_fence(float& r) {
    asm volatile("" : "+f"(r)::"memory");
}
__device__ __forceinline__ void reg_fence(unsigned& r) {
    asm volatile("" : "+r"(r)::"memory");
}

// d (64x128 f32, the warp group's) = a (64x8 tf32, registers) @ b (8x128
// tf32, shared memory, K-major, descriptor b), plus d where SCALE_D is 1.
// Warp w of the group holds rows 16w .. 16w + 15: lane 4g + t holds a[i]
// at (g + 8 (i % 2), t + 4 (i / 2)) and d[4j + i] at (g + 8 (i / 2),
// 8j + 2t + i % 2).  Asynchronous: a and d are not to be touched until
// wgmma_wait says the group is done.
template <int SCALE_D>
__device__ __forceinline__ void wgmma_tf32_m64n128(float (&d)[64],
                                                   const unsigned (&a)[4],
                                                   unsigned long long b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39,"
        "%40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55,"
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(SCALE_D));
}

// The same on a 64-column B (8x64, descriptor b): d (64x64 f32), d[4j + i]
// at (g + 8 (i / 2), 8j + 2t + i % 2) of warp w's rows.
template <int SCALE_D>
__device__ __forceinline__ void wgmma_tf32_m64n64(float (&d)[32],
                                                  const unsigned (&a)[4],
                                                  unsigned long long b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(SCALE_D));
}

}  // namespace tbt
