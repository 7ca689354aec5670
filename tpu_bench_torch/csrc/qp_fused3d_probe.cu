// K1 qp_fused3d's probe form (P = true in csrc/qp_fused3d.cuh): its entries
// tbt_qp_fused3d_probe_<dtype>, which kernels/bwdtrans3d.py launches in
// place of tbt_qp_fused3d_<dtype> only while a torch profiler records.
// They take K1's arguments, then the probe's buffer (QPProbe: the phase
// totals, the launch spans and the newest launch's block records), the
// launch's number and the block records the buffer holds.  Every form of
// K1 has its probe instance.  This file is its own nvcc process, so the
// library's build, whose sources compile side by side, does not wait on
// K1's instances twice in one process.

#include <cuda_runtime.h>

#include "common.cuh"
#include "qp_fused3d.cuh"

namespace {

template <typename T>
int launch_probe(const void* in, const void* b0, const void* c12t, void* out,
                 int nm0, int nrq, int nq0, int nkj, long long n_elem, int et,
                 int g, int depth, int threads, int body, void* probe,
                 long long launch_no, long long capacity, void* stream) {
    if (probe == nullptr || launch_no < 0 || capacity < 0)
        return cudaErrorInvalidValue;
    const QPProbe pr{static_cast<unsigned long long*>(probe), launch_no,
                     capacity, 0};
    return launch<T, true>(static_cast<const T*>(in),
                           static_cast<const T*>(b0),
                           static_cast<const T*>(c12t), static_cast<T*>(out),
                           nm0, nrq, nq0, nkj, n_elem, et, g, depth, threads,
                           body, static_cast<cudaStream_t>(stream), pr);
}

}  // namespace

extern "C" int tbt_qp_fused3d_probe_f32(const void* in, const void* b0,
                                        const void* c12t, void* out, int nm0,
                                        int nrq, int nq0, int nkj,
                                        long long n_elem, int et, int g,
                                        int depth, int threads, int body,
                                        void* probe, long long launch_no,
                                        long long capacity, void* stream) {
    return launch_probe<float>(in, b0, c12t, out, nm0, nrq, nq0, nkj, n_elem,
                               et, g, depth, threads, body, probe, launch_no,
                               capacity, stream);
}

extern "C" int tbt_qp_fused3d_probe_f64(const void* in, const void* b0,
                                        const void* c12t, void* out, int nm0,
                                        int nrq, int nq0, int nkj,
                                        long long n_elem, int et, int g,
                                        int depth, int threads, int body,
                                        void* probe, long long launch_no,
                                        long long capacity, void* stream) {
    return launch_probe<double>(in, b0, c12t, out, nm0, nrq, nq0, nkj,
                                n_elem, et, g, depth, threads, body, probe,
                                launch_no, capacity, stream);
}

extern "C" int tbt_qp_fused3d_probe_bf16(const void* in, const void* b0,
                                         const void* c12t, void* out, int nm0,
                                         int nrq, int nq0, int nkj,
                                         long long n_elem, int et, int g,
                                         int depth, int threads, int body,
                                         void* probe, long long launch_no,
                                         long long capacity, void* stream) {
    return launch_probe<tbt::bf16>(in, b0, c12t, out, nm0, nrq, nq0, nkj,
                                   n_elem, et, g, depth, threads, body, probe,
                                   launch_no, capacity, stream);
}
