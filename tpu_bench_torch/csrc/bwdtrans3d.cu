// K1 qp_fused3d: the fused 3D sum-factorization of benchmark05's BwdTrans,
// and K4 qp_stage2_3d (below): stage 2 of its two-kernel form.
//
// Replaces the Pallas kernels tpu_bench/kernels/bwdtrans3d.py:qp_shared3d
// (_qp_fused_kernel3d) and qp_shared3d_flat (_qp_fused_flat_kernel3d).  Both
// hand over the same contiguous bytes, read here as in (nm0*nrq, E) and
// written as out (nq0*nkj, E), element index fastest:
//
//   out[i*nkj + kj, e] = sum_rq C12T[kj, rq] * sum_p B0[p, i] * in[p*nrq + rq, e]
//
// with nrq = nm2*nm1 and nkj = nq2*nq1 (49 and 64 at nq=8^3).
//
// It also serves benchmark04's Pallas(QP/Shared) column: the 2D
// sum-factorization is the same contraction with nrq = nm1, nkj = nq1 and
// C12T = B1^T, so one kernel replaces tpu_bench/kernels/bwdtrans2d.py:
// qp_shared, qp_w, qp_w_flat and qp_mxu_grouped, whose differences were TPU
// sublane and MXU-tile geometry.  nm1 <= 31 (b04's nq <= 32) sits in the
// 16 and 49 register buckets below.
//
// What bounds it on an H100: each element streams nm0*nrq values in and
// nq0*nkj out exactly once (343 + 512 at nq=8^3) and takes
// 2*nq0*nrq*(nm0 + nkj) FLOP (55,664 at nq=8^3): about 16 FLOP per byte in
// f32 and 8 in f64, close to the card's ratio of FMA rate to memory
// bandwidth in both types.  So the design keeps the FMA stream lean and the
// memory stream coalesced:
//   - one thread per element, elements along threadIdx.x: a warp reads and
//     writes 32 consecutive e of one row (coalesced), ragged edge masked;
//   - B0 and C12T staged in shared memory once per block; every thread
//     reads the same address, so each load is a broadcast;
//   - the plane intermediate v[nrq] lives in registers: the rq loops are
//     unrolled to a compile-time bound MAXRQ with a run-time guard, so no
//     local memory is used; where registers allow, two planes share each
//     load (NI below).
// The input is read once per output plane i (nq0 times per element); the
// repeats hit L1/L2.  Staging the element tile in shared memory, TMA and
// wgmma are later work.  (A stage 2 that read C12T transposed in 16-byte
// loads, four outputs per load, ran 2.1x slower in f32 on the H100.)

#include <cuda_runtime.h>

namespace {

template <typename T, int MAXRQ>
__global__ void qp_fused3d_kernel(const T* __restrict__ in,
                                  const T* __restrict__ b0,
                                  const T* __restrict__ c12t,
                                  T* __restrict__ out, int nm0, int nrq,
                                  int nq0, int nkj, long long n_elem) {
    // NI output planes per pass: each input value loaded in stage 1 and
    // each C12T value loaded in stage 2 then serves NI FMAs.  Two planes in
    // the f32 17..49 bucket only: on the H100 that cut nq=6^3 and 8^3 by
    // 30%, while two planes of the 16 bucket ran slower at nq=4^3 and
    // (3,4,5) in f32, and v of the larger f64 buckets does not fit.
    constexpr int NI = sizeof(T) == 4 && MAXRQ == 49 ? 2 : 1;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* s_b0 = reinterpret_cast<T*>(smem_raw);  // (nm0, nq0)
    T* s_c = s_b0 + nm0 * nq0;                 // (nkj, nrq)
    for (int t = threadIdx.x; t < nm0 * nq0; t += blockDim.x) s_b0[t] = b0[t];
    for (int t = threadIdx.x; t < nkj * nrq; t += blockDim.x) s_c[t] = c12t[t];
    __syncthreads();

    const long long e = blockIdx.x * static_cast<long long>(blockDim.x) +
                        threadIdx.x;
    if (e >= n_elem) return;
    const T* x = in + e;
    T* y = out + e;
    for (int i0 = 0; i0 < nq0; i0 += NI) {
        T v[NI][MAXRQ];
#pragma unroll
        for (int u = 0; u < NI; ++u)
#pragma unroll
            for (int rq = 0; rq < MAXRQ; ++rq) v[u][rq] = T(0);
        for (int p = 0; p < nm0; ++p) {
            T w[NI];
#pragma unroll
            for (int u = 0; u < NI; ++u)
                w[u] = i0 + u < nq0 ? s_b0[p * nq0 + i0 + u] : T(0);
            const T* xp = x + static_cast<long long>(p) * nrq * n_elem;
#pragma unroll
            for (int rq = 0; rq < MAXRQ; ++rq) {
                if (rq < nrq) {
                    const T xv = __ldg(xp + rq * n_elem);
#pragma unroll
                    for (int u = 0; u < NI; ++u)
                        v[u][rq] = fma(w[u], xv, v[u][rq]);
                }
            }
        }
        for (int kj = 0; kj < nkj; ++kj) {
            const T* c = s_c + kj * nrq;
            T acc[NI];
#pragma unroll
            for (int u = 0; u < NI; ++u) acc[u] = T(0);
#pragma unroll
            for (int rq = 0; rq < MAXRQ; ++rq) {
                if (rq < nrq) {
                    const T cv = c[rq];
#pragma unroll
                    for (int u = 0; u < NI; ++u)
                        acc[u] = fma(cv, v[u][rq], acc[u]);
                }
            }
#pragma unroll
            for (int u = 0; u < NI; ++u) {
                if (i0 + u < nq0)
                    y[(static_cast<long long>(i0 + u) * nkj + kj) * n_elem] =
                        acc[u];
            }
        }
    }
}

template <typename T, int MAXRQ>
int launch_bucket(const T* in, const T* b0, const T* c12t, T* out, int nm0,
                  int nrq, int nq0, int nkj, long long n_elem, int epb,
                  cudaStream_t stream) {
    const size_t smem =
        sizeof(T) * static_cast<size_t>(nm0 * nq0 + nkj * nrq);
    auto kernel = qp_fused3d_kernel<T, MAXRQ>;
    if (smem > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (err != cudaSuccess) return err;
    }
    const long long blocks = (n_elem + epb - 1) / epb;
    kernel<<<static_cast<unsigned>(blocks), epb, smem, stream>>>(
        in, b0, c12t, out, nm0, nrq, nq0, nkj, n_elem);
    return cudaGetLastError();
}

// Register buckets for v[nrq]: nrq <= 16 covers nq <= 5, <= 49 covers
// nq 6-8 and <= 81 covers nq 9-10 (isotropic orders).  The Python wrapper
// refuses nrq > 81 before it gets here.
template <typename T>
int launch(const T* in, const T* b0, const T* c12t, T* out, int nm0, int nrq,
           int nq0, int nkj, long long n_elem, int epb, cudaStream_t stream) {
    if (n_elem <= 0) return cudaSuccess;
    if (nrq <= 16)
        return launch_bucket<T, 16>(in, b0, c12t, out, nm0, nrq, nq0, nkj,
                                    n_elem, epb, stream);
    if (nrq <= 49)
        return launch_bucket<T, 49>(in, b0, c12t, out, nm0, nrq, nq0, nkj,
                                    n_elem, epb, stream);
    if (nrq <= 81)
        return launch_bucket<T, 81>(in, b0, c12t, out, nm0, nrq, nq0, nkj,
                                    n_elem, epb, stream);
    return cudaErrorInvalidValue;
}

// K4 qp_stage2_3d: stage 2 of benchmark05's and benchmark04's Pallas(QP).
//
// Replaces tpu_bench/kernels/bwdtrans3d.py:qp_global3d's second
// pallas_call (_stage2_kernel3d) and tpu_bench/kernels/bwdtrans2d.py:
// qp_global's (_stage2_kernel), the p contraction of the workspace that
// stage 1 (K2, w[p] = C12T @ in[p], or B1^T @ in[p] in 2D) left in device
// memory:
//
//   out[i*nkj + kj, e] = sum_p B0[p, i] * w[p*nkj + kj, e]
//
// with w (nm0, nkj, E) and out (nq0, nkj, E), element index fastest;
// nkj = nq2*nq1 in 3D and nq1 in 2D.
//
// What bounds it on an H100: memory.  Each (kj, e) reads nm0 values and
// writes nq0 (7 and 8 at nq=8^3) for 2*nm0*nq0 FLOP, under 2 FLOP per byte.
// So one thread owns one (kj, e): elements along threadIdx.x (coalesced,
// ragged edge masked), kj on blockIdx.y; its nm0 workspace values are read
// once into registers (unrolled to a compile-time bucket MAXP with a
// run-time guard: 16 covers nm0 <= 16, 32 the 2D nq=32 order) and B0 sits
// in shared memory, where every thread reads the same address (broadcast).
constexpr int QP2_MAX_NM0 = 32;
constexpr int QP2_MAX_THREADS = 512;

template <typename T, int MAXP>
__global__ void __launch_bounds__(QP2_MAX_THREADS) qp_stage2_3d_kernel(const T* __restrict__ w,
                                    const T* __restrict__ b0,
                                    T* __restrict__ out, int nm0, int nq0,
                                    int nkj, long long n_elem) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* s_b0 = reinterpret_cast<T*>(smem_raw);  // (nm0, nq0)
    for (int t = threadIdx.x; t < nm0 * nq0; t += blockDim.x) s_b0[t] = b0[t];
    __syncthreads();

    const long long e = blockIdx.x * static_cast<long long>(blockDim.x) +
                        threadIdx.x;
    if (e >= n_elem) return;
    const long long kj = blockIdx.y;
    T v[MAXP];
#pragma unroll
    for (int p = 0; p < MAXP; ++p)
        v[p] = p < nm0 ? __ldg(w + (p * nkj + kj) * n_elem + e) : T(0);
    for (int i = 0; i < nq0; ++i) {
        T acc = T(0);
#pragma unroll
        for (int p = 0; p < MAXP; ++p)
            if (p < nm0) acc = fma(s_b0[p * nq0 + i], v[p], acc);
        out[(i * nkj + kj) * n_elem + e] = acc;
    }
}

template <typename T>
int launch_qp_stage2(const T* w, const T* b0, T* out, int nm0, int nq0,
                     int nkj, long long n_elem, int epb,
                     cudaStream_t stream) {
    if (n_elem <= 0 || nkj <= 0) return cudaSuccess;
    if (nm0 > QP2_MAX_NM0 || nkj > 65535 || epb > QP2_MAX_THREADS)
        return cudaErrorInvalidValue;
    const size_t smem = sizeof(T) * static_cast<size_t>(nm0 * nq0);
    const dim3 grid(static_cast<unsigned>((n_elem + epb - 1) / epb), nkj);
    auto kernel = nm0 <= 16 ? &qp_stage2_3d_kernel<T, 16>
                            : &qp_stage2_3d_kernel<T, QP2_MAX_NM0>;
    kernel<<<grid, epb, smem, stream>>>(w, b0, out, nm0, nq0, nkj, n_elem);
    return cudaGetLastError();
}

}  // namespace

extern "C" int tbt_qp_stage2_3d_f32(const void* w, const void* b0, void* out,
                                    int nm0, int nq0, int nkj,
                                    long long n_elem, int epb, void* stream) {
    return launch_qp_stage2(static_cast<const float*>(w),
                            static_cast<const float*>(b0),
                            static_cast<float*>(out), nm0, nq0, nkj, n_elem,
                            epb, static_cast<cudaStream_t>(stream));
}

extern "C" int tbt_qp_stage2_3d_f64(const void* w, const void* b0, void* out,
                                    int nm0, int nq0, int nkj,
                                    long long n_elem, int epb, void* stream) {
    return launch_qp_stage2(static_cast<const double*>(w),
                            static_cast<const double*>(b0),
                            static_cast<double*>(out), nm0, nq0, nkj, n_elem,
                            epb, static_cast<cudaStream_t>(stream));
}

extern "C" int tbt_qp_fused3d_f32(const void* in, const void* b0,
                                  const void* c12t, void* out, int nm0,
                                  int nrq, int nq0, int nkj, long long n_elem,
                                  int epb, void* stream) {
    return launch(static_cast<const float*>(in), static_cast<const float*>(b0),
                  static_cast<const float*>(c12t), static_cast<float*>(out),
                  nm0, nrq, nq0, nkj, n_elem, epb,
                  static_cast<cudaStream_t>(stream));
}

extern "C" int tbt_qp_fused3d_f64(const void* in, const void* b0,
                                  const void* c12t, void* out, int nm0,
                                  int nrq, int nq0, int nkj, long long n_elem,
                                  int epb, void* stream) {
    return launch(static_cast<const double*>(in),
                  static_cast<const double*>(b0),
                  static_cast<const double*>(c12t), static_cast<double*>(out),
                  nm0, nrq, nq0, nkj, n_elem, epb,
                  static_cast<cudaStream_t>(stream));
}

extern "C" const char* tbt_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
