// K4: the projection glue around the spectral Poisson solve
// (pres_2.cxx:156-196 and :364-387).
//
// Replaces the TPU kernel family PresGlue (microhh_tpu/ops/pallas_fused.py):
//  * pres_rhs  <- PresGlue.rhs (:2591, pallas_call :2604, _pres_rhs_body):
//    rhs = dti * div(rho s*) on the interior levels, in one pass over s*;
//  * pres_apply <- PresGlue.apply (:2613, pallas_call :2634,
//    _pres_apply_uvw_body): s* -= dt grad p and, unless it is the last
//    substep, t -= cA_next grad p, for u, v and w, updated IN PLACE.
//
// Bound: device-memory bytes (a few flops per value).  Design: one thread
// per (j, i) column marching k.  pres_rhs carries w at the upper half
// level to the next level in a register; pres_apply reads each p plane
// once for all three gradient components and carries p[k-1] in a
// register for the vertical gradient.  The i/j neighbours are read from
// device memory by the adjacent threads of the same warp and hit in L1.
#include <cuda_runtime.h>

namespace mhh {

// per-level table columns (ops/fused.py P_*)
enum { P_RHO, P_RHOH, P_RHOH1, P_DZI, P_DZHI, NP };

template <typename T>
__global__ void pres_rhs_kernel(const T* __restrict__ u,
                                const T* __restrict__ v,
                                const T* __restrict__ w, T* __restrict__ out,
                                const T* __restrict__ pc, int itot, int jtot,
                                int ktot, int ks, T dxi, T dyi, T dti) {
    const long long plane = (long long)itot * jtot;
    const long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (n >= plane) return;
    const int j = (int)(n / itot), i = (int)(n - (long long)j * itot);
    const long long nip = (long long)j * itot + (i + 1 == itot ? 0 : i + 1);
    const long long njp = (long long)(j + 1 == jtot ? 0 : j + 1) * itot + i;
    T wk = w[(long long)ks * plane + n];
    for (int k = 0; k < ktot; ++k) {
        const T* c = pc + k * NP;
        const long long b = (long long)(ks + k) * plane;
        const T w1 = w[b + plane + n];
        const T uc = u[b + n], vc = v[b + n];
        out[(long long)k * plane + n] =
            dti * (c[P_RHO] * ((u[b + nip] - uc) * dxi + (v[b + njp] - vc) * dyi)
                   + (c[P_RHOH1] * w1 - c[P_RHOH] * wk) * c[P_DZI]);
        wk = w1;
    }
}

template <typename T>
__global__ void pres_apply_kernel(const T* __restrict__ p, T* su, T* sv,
                                  T* sw, T* tu, T* tv, T* tw,
                                  const T* __restrict__ pc, int itot, int jtot,
                                  int ktot, int ks, T dxi, T dyi, T dt, T can,
                                  int carry) {
    const long long plane = (long long)itot * jtot;
    const long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (n >= plane) return;
    const int j = (int)(n / itot), i = (int)(n - (long long)j * itot);
    const long long nim = (long long)j * itot + (i == 0 ? itot - 1 : i - 1);
    const long long njm = (long long)(j == 0 ? jtot - 1 : j - 1) * itot + i;
    T pprev = T(0);
    for (int k = 0; k < ktot; ++k) {
        const long long b = (long long)k * plane;
        const T pk = p[b + n];
        const T gu = (pk - p[b + nim]) * dxi;
        const T gv = (pk - p[b + njm]) * dyi;
        // k == 0 is the bottom wall w level, held at its value
        const T gw = k == 0 ? T(0) : (pk - pprev) * pc[k * NP + P_DZHI];
        const long long o = (long long)(ks + k) * plane + n;
        su[o] = su[o] - dt * gu;
        sv[o] = sv[o] - dt * gv;
        sw[o] = sw[o] - dt * gw;
        if (carry) {
            tu[o] = tu[o] - can * gu;
            tv[o] = tv[o] - can * gv;
            tw[o] = tw[o] - can * gw;
        }
        pprev = pk;
    }
}

template <typename T>
int launch_pres_rhs(const T* u, const T* v, const T* w, T* out, const T* pc,
                    int itot, int jtot, int ktot, int ks, double dxi,
                    double dyi, double dti, cudaStream_t stream) {
    const long long plane = (long long)itot * jtot;
    const int threads = 256;
    pres_rhs_kernel<T><<<(unsigned int)((plane + threads - 1) / threads),
                         threads, 0, stream>>>(
        u, v, w, out, pc, itot, jtot, ktot, ks, T(dxi), T(dyi), T(dti));
    return (int)cudaGetLastError();
}

template <typename T>
int launch_pres_apply(const T* p, T* su, T* sv, T* sw, T* tu, T* tv, T* tw,
                      const T* pc, int itot, int jtot, int ktot, int ks,
                      double dxi, double dyi, double dt, double can, int carry,
                      cudaStream_t stream) {
    const long long plane = (long long)itot * jtot;
    const int threads = 256;
    pres_apply_kernel<T><<<(unsigned int)((plane + threads - 1) / threads),
                           threads, 0, stream>>>(
        p, su, sv, sw, tu, tv, tw, pc, itot, jtot, ktot, ks, T(dxi), T(dyi),
        T(dt), T(can), carry);
    return (int)cudaGetLastError();
}

}  // namespace mhh

#define MHH_PRES(SUF, T)                                                      \
    extern "C" int mhh_pres_rhs_##SUF(                                        \
        const void* u, const void* v, const void* w, void* out,               \
        const void* pc, int itot, int jtot, int ktot, int ks, double dxi,     \
        double dyi, double dti, void* stream) {                               \
        return mhh::launch_pres_rhs<T>((const T*)u, (const T*)v, (const T*)w, \
                                       (T*)out, (const T*)pc, itot, jtot,     \
                                       ktot, ks, dxi, dyi, dti,               \
                                       (cudaStream_t)stream);                 \
    }                                                                         \
    extern "C" int mhh_pres_apply_##SUF(                                      \
        const void* p, void* su, void* sv, void* sw, void* tu, void* tv,      \
        void* tw, const void* pc, int itot, int jtot, int ktot, int ks,       \
        double dxi, double dyi, double dt, double can, int carry,             \
        void* stream) {                                                       \
        return mhh::launch_pres_apply<T>(                                     \
            (const T*)p, (T*)su, (T*)sv, (T*)sw, (T*)tu, (T*)tv, (T*)tw,      \
            (const T*)pc, itot, jtot, ktot, ks, dxi, dyi, dt, can, carry,     \
            (cudaStream_t)stream);                                            \
    }

MHH_PRES(f32, float)
MHH_PRES(f64, double)
