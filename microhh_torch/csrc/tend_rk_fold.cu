// K22: the folded form of the dry RK sweep.  One k-march computes what K1,
// K2 and K4 rhs compute in three: the Smagorinsky eddy viscosity, advec_2 +
// Smagorinsky diffusion + dry buoyancy + static sponge + geostrophic
// Coriolis term of u, v, w, th with the low-storage RK update folded in
// (s* = s + cB*dt*t_total, carry = cA_next*t_total), and the Poisson
// right-hand side dti * div(rho s*).  The eddy viscosity e(k) is written out
// as well: the MOST wall patches read it and the step keeps it in aux.
//
// Replaces the TPU kernel FusedLES2.tendencies_rk in its tiled fold_ghosts
// form (microhh_tpu/ops/pallas_fused.py:1875, call :2073, body
// _all_tiled_rk_ev_body :910) and, with e_in given (the eddy viscosity read
// instead of computed), the same sweep without the evisc fold (call :2108,
// bodies _all_tiled_rk_ring_body :824 and _all_tiled_rk_body :1137 under
// want_rhs).  Fields are read raw with clamped k neighbours (u, v, th to
// [ks, ke-1], w to [ks, ke]); a null th gives the has_thermo=False form.
//
// Bound: device-memory bytes (4 fields and 4 carries in, 4 s*, 4 carries, e
// and rhs out: 72 B a point in f32 against ~900 operations).
//
// Design.  A block of TI x TJ threads owns a (TJ, TI) tile and marches in k.
// * The rhs of a cell needs u* at i+1 and v* at j+1, which belong to the
//   neighbouring tiles: the block computes those tendencies itself (one
//   column and one row beyond its tile, by 8 + 32 threads after the tile's
//   own points) and never reads a neighbour's output.  The eddy viscosity
//   is therefore needed on the tile plus one cell, and the fields on the
//   tile plus two: each field keeps a ring of five (TJ+4, TI+4) planes in
//   shared memory and e a ring of five (TJ+2, TI+2) planes.
// * At step k the block computes e(k+1) from the fields' planes k .. k+2,
//   then the tendencies of plane k from e(k-1 .. k+1), while plane k+3 is
//   on its way (cp.async into the slot of plane k-2, which nothing reads any
//   more): two barriers a level, and no wait for device memory between
//   them.  Where a thread's elements of a plane lie does not depend on the
//   level, so the periodic wrap is taken once, before the march.
//   e(0) is the MOST surface row when one is given (it must hold the
//   previous substep's MO gradients, so the caller computes it before the
//   surface model runs), else the interior formula on clamped planes; e(-1)
//   and e(ktot) repeat the edge planes, as K2's clamped reads do.
// * rhs(k) needs w*(k+1): the thread keeps rho div_h - rhoh w* dzi of the
//   last plane in a register, completes it one plane late and flushes the
//   top plane with w*(ke) = 0 after the march.  div_h of level k is taken
//   from u*, v* in shared memory after the next level's first barrier.
// * The carries of u and v are read one cell inside the neighbouring tiles,
//   whose blocks overwrite them: they are read from tu_in, tv_in and written
//   to tu_out, tv_out, which the wrapper makes different buffers whenever
//   both happen.  w's and th's carries are updated in place.
// * Everything is periodic, so a partial tile computes its virtual points
//   (i >= itot or j >= jtot wrap around) like any other and only guards its
//   writes: the cell beyond the last one inside is then a tile point.
// Shared memory is dynamic: 44 KB in f32, 87 KB in f64.
#include <cuda_pipeline.h>

#include "les_math.cuh"

namespace mhh {

constexpr int H2 = 2;                       // halo of the field planes
constexpr int FJ = TJ + 2 * H2, FI = TI + 2 * H2;
constexpr int NR = 5;                       // depth of the rings
constexpr int FPT = (FJ * FI + TI * TJ - 1) / (TI * TJ);   // loads a thread
// blocks an SM that the register cap allows: three in f32 (80 registers, no
// spill; two blocks at 93 registers ran 20% slower, four at 64 with a spill
// 2% slower), two in f64 (128 registers; three spill and ran 40% slower)
#define MHH_FOLD_MIN_BLOCKS(T) (sizeof(T) == 4 ? 3 : 2)

// ring slot of logical plane p >= -1
__device__ __forceinline__ int fslot(int p) { return (p + NR) % NR; }

template <typename T>
struct FoldShared {
    T f[4][NR][FJ][FI];     // u, v, w, th
    T e[NR][HJ][HI];        // eddy viscosity on the tile plus one cell
    T su[TJ][TI + 1];       // u* on the tile and one column beyond
    T sv[TJ + 1][TI];       // v* on the tile and one row beyond
};

template <typename T>
struct FoldArgs {
    const T *u, *v, *w, *th;        // th null: no thermo
    const T *e_in;                  // interior evisc to read, or null
    const T *se;                    // (jtot, itot) surface row of e, or null
    T *us, *vs, *ws, *ths;
    const T *tu_in, *tv_in;         // null when first
    T *tu_out, *tv_out;             // null unless carry
    T *tw, *tth;                    // in place
    T *e_out;                       // (ktot, jtot, itot), null with e_in
    T *rhs;                         // (ktot, jtot, itot)
    const T *ct, *ce;               // (ktot, NTG) and (ktot, NE) tables
    int itot, jtot, ktot, ks;
    T dxi, dyi, visc, svisc, tPr, cbdt, can, dti, fc, utrans, vtrans;
    int first, carry, coriolis;
};

template <typename T>
__global__ void
__launch_bounds__(TI * TJ, MHH_FOLD_MIN_BLOCKS(T))
tend_rk_fold_kernel(const FoldArgs<T> a) {
    extern __shared__ __align__(16) unsigned char fold_shared_raw[];
    FoldShared<T>& sm = *reinterpret_cast<FoldShared<T>*>(fold_shared_raw);
    typedef ViewT<T, FJ, FI> FV;

    const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * TI + tx;
    const int i0 = blockIdx.x * TI, j0 = blockIdx.y * TJ;
    const int i = i0 + tx, j = j0 + ty;
    const int itot = a.itot, jtot = a.jtot, kt = a.ktot, ks = a.ks;
    const int ke = ks + kt;
    const bool inside = i < itot && j < jtot;
    const bool thermo = a.th != nullptr;
    const long long plane = (long long)itot * jtot;
    const T grav = T(9.81);
    const T dxi = a.dxi, dyi = a.dyi, visc = a.visc, cbdt = a.cbdt;

    // where in a plane this thread's elements of the field tile lie: the
    // same at every level, so the periodic wrap is taken once
    int goff[FPT];
#pragma unroll
    for (int q = 0; q < FPT; ++q) {
        const int idx = tid + q * TI * TJ;
        const int r = idx / FI, c = idx - r * FI;
        goff[q] = idx < FJ * FI
            ? wrap(j0 + r - H2, jtot) * itot + wrap(i0 + c - H2, itot) : -1;
    }

    // start the copy of the fields' plane p (clamped) into its ring slot;
    // fold_wait() then a barrier make it readable
    auto load = [&](int p) {
        const int s = fslot(p);
        const long long cell = (long long)clampi(ks + p, ks, ke - 1) * plane;
        const long long half = (long long)clampi(ks + p, ks, ke) * plane;
#pragma unroll
        for (int q = 0; q < FPT; ++q) {
            if (goff[q] < 0) continue;
            const int idx = tid + q * TI * TJ;
            __pipeline_memcpy_async(&sm.f[0][s][0][0] + idx,
                                    a.u + cell + goff[q], sizeof(T));
            __pipeline_memcpy_async(&sm.f[1][s][0][0] + idx,
                                    a.v + cell + goff[q], sizeof(T));
            __pipeline_memcpy_async(&sm.f[2][s][0][0] + idx,
                                    a.w + half + goff[q], sizeof(T));
            if (thermo)
                __pipeline_memcpy_async(&sm.f[3][s][0][0] + idx,
                                        a.th + cell + goff[q], sizeof(T));
        }
        __pipeline_commit();
    };

    // e of interior plane p into its slot; the edge planes also into the
    // slots of the clamped planes -1 and ktot
    auto evisc_plane = [&](int p) {
        const Slots q{fslot(p - 1), fslot(p), fslot(p + 1)};
        const T* src = a.e_in ? a.e_in + (long long)p * plane
                              : (p == 0 ? a.se : nullptr);
        const T* cc = a.ce + (long long)p * NE;
        for (int idx = tid; idx < HJ * HI; idx += TI * TJ) {
            const int r = idx / HI, c = idx - r * HI;
            T ev;
            if (src) {
                ev = __ldg(src + (long long)wrap(j0 + r - 1, jtot) * itot
                           + wrap(i0 + c - 1, itot));
            } else {
                // the region's point (r, c) lies at (r+1, c+1) of the fields
                const FV U{sm.f[0], r + 1, c + 1}, V{sm.f[1], r + 1, c + 1};
                const FV W{sm.f[2], r + 1, c + 1}, A{sm.f[3], r + 1, c + 1};
                ev = evisc_math(U, V, W, A, q, cc, dxi, dyi, a.tPr,
                                thermo ? 1 : 0, T(0));
            }
            sm.e[q.kc][r][c] = ev;
            if (p == 0) sm.e[q.km][r][c] = ev;
            if (p == kt - 1) sm.e[q.kp][r][c] = ev;
        }
    };

    // the thread's point and, for the threads that take one, its point
    // beyond the tile, as cells of a plane (wrapped: a partial tile's
    // virtual points read the carries of the cells they stand for)
    const int cell = wrap(j, jtot) * itot + wrap(i, itot);
    const int beyond = tid < TJ
        ? wrap(j0 + tid, jtot) * itot + wrap(i0 + TI, itot)
        : wrap(j0 + TJ, jtot) * itot + wrap(i0 + (tid & 31), itot);

    // u's and v's total tendency at a point (cell of its plane) of the tile
    // or just beyond it
    auto u_total = [&](const FV& U, const FV& V, const FV& W, const View<T>& E,
                       Slots q, const T* cc, int cell, int k) {
        T ut = u_tend(U, V, W, E, q, cc, dxi, dyi, visc)
               + u_folds(U, V, q.kc, cc, a.fc, a.vtrans, a.coriolis);
        if (!a.first)
            ut = __ldg(a.tu_in + (long long)(ks + k) * plane + cell) + ut;
        return ut;
    };
    auto v_total = [&](const FV& U, const FV& V, const FV& W, const View<T>& E,
                       Slots q, const T* cc, int cell, int k) {
        T vt = v_tend(U, V, W, E, q, cc, dxi, dyi, visc)
               + v_folds(U, V, q.kc, cc, a.fc, a.utrans, a.coriolis);
        if (!a.first)
            vt = __ldg(a.tv_in + (long long)(ks + k) * plane + cell) + vt;
        return vt;
    };

    // rhs of level k from u*, v* of that level in su, sv and w* of the
    // thread: completes the level below, keeps this one's part
    T xprev = T(0);     // rho div_h(s*) - rhoh w* dzi of the level below
    T ws_ = T(0);       // the thread's w* of the level last swept
    auto emit_rhs = [&](int k) {
        if (!inside) return;
        const T* cc = a.ct + (long long)k * NTG;
        const T divh = (sm.su[ty][tx + 1] - sm.su[ty][tx]) * dxi
                       + (sm.sv[ty + 1][tx] - sm.sv[ty][tx]) * dyi;
        const T wflux = cc[T_RHOH] * ws_;
        const long long oi = (long long)k * plane + (long long)j * itot + i;
        if (k > 0)
            a.rhs[oi - plane] = a.dti * (xprev + wflux * cc[T_DZI_M1]);
        xprev = cc[T_RHO] * divh - wflux * cc[T_DZI];
        if (k == kt - 1) a.rhs[oi] = a.dti * xprev;     // w*(ke) = 0
    };

    load(-1);
    load(0);
    load(1);
    __pipeline_wait_prior(0);
    __syncthreads();
    load(2);
    evisc_plane(0);

    for (int k = 0; k < kt; ++k) {
        // plane k+2 has landed; every thread is past the sweep of level k-1
        __pipeline_wait_prior(0);
        __syncthreads();
        // plane k+3 goes where plane k-2 lay, which nothing reads any more
        if (k + 3 <= kt) load(k + 3);
        if (k > 0) emit_rhs(k - 1);
        if (k + 1 < kt) evisc_plane(k + 1);
        __syncthreads();

        const Slots q{fslot(k - 1), fslot(k), fslot(k + 1)};
        const T* cc = a.ct + (long long)k * NTG;
        const long long o = (long long)(ks + k) * plane + (long long)j * itot + i;
        {
            const FV U{sm.f[0], ty + H2, tx + H2}, V{sm.f[1], ty + H2, tx + H2};
            const FV W{sm.f[2], ty + H2, tx + H2}, A{sm.f[3], ty + H2, tx + H2};
            const View<T> E{sm.e, ty + 1, tx + 1};
            const T ut = u_total(U, V, W, E, q, cc, cell, k);
            const T vt = v_total(U, V, W, E, q, cc, cell, k);
            const T us_ = U(q.kc, 0, 0) + cbdt * ut;
            const T vs_ = V(q.kc, 0, 0) + cbdt * vt;
            sm.su[ty][tx] = us_;
            sm.sv[ty][tx] = vs_;
            if (inside) {
                a.us[o] = us_;
                a.vs[o] = vs_;
                if (a.carry) {
                    a.tu_out[o] = a.can * ut;
                    a.tv_out[o] = a.can * vt;
                }
                const T w_ = W(q.kc, 0, 0);
                T wt = w_tend(U, V, W, E, q, cc, dxi, dyi, visc)
                       - cc[T_FACZH] * w_;
                T a_ = T(0), tht = T(0);
                if (thermo) {
                    const T threfh = cc[T_THREFH];
                    a_ = A(q.kc, 0, 0);
                    wt = wt + grav / threfh * (i2(A(q.km, 0, 0), a_) - threfh);
                    tht = s_tend(U, V, W, A, E, q, cc, dxi, dyi, a.svisc,
                                 T(1) / a.tPr)
                          - cc[T_FACZ] * (a_ - cc[T_SREF]);
                }
                if (k == 0) wt = T(0);      // half level ks is the wall
                if (!a.first) {
                    wt = a.tw[o] + wt;
                    if (thermo) tht = a.tth[o] + tht;
                }
                ws_ = w_ + cbdt * wt;
                a.ws[o] = ws_;
                if (thermo) a.ths[o] = a_ + cbdt * tht;
                if (a.carry) {
                    a.tw[o] = a.can * wt;
                    if (thermo) a.tth[o] = a.can * tht;
                }
                if (a.e_out)
                    a.e_out[o - (long long)ks * plane] = E(q.kc, 0, 0);
            }
        }
        // u* one column and v* one row beyond the tile, by two warps
        if (tid < TJ) {
            const int r = tid;
            const FV U{sm.f[0], r + H2, TI + H2}, V{sm.f[1], r + H2, TI + H2};
            const FV W{sm.f[2], r + H2, TI + H2};
            const View<T> E{sm.e, r + 1, TI + 1};
            sm.su[r][TI] = U(q.kc, 0, 0)
                + cbdt * u_total(U, V, W, E, q, cc, beyond, k);
        } else if (tid >= 32 && tid < 32 + TI) {
            const int c = tid - 32;
            const FV U{sm.f[0], TJ + H2, c + H2}, V{sm.f[1], TJ + H2, c + H2};
            const FV W{sm.f[2], TJ + H2, c + H2};
            const View<T> E{sm.e, TJ + 1, c + 1};
            sm.sv[TJ][c] = V(q.kc, 0, 0)
                + cbdt * v_total(U, V, W, E, q, cc, beyond, k);
        }
    }
    __syncthreads();
    emit_rhs(kt - 1);
}

template <typename T>
int launch_tend_rk_fold(const FoldArgs<T>& args, cudaStream_t stream) {
    const size_t bytes = sizeof(FoldShared<T>);
    cudaError_t rc = cudaFuncSetAttribute(
        tend_rk_fold_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (rc != cudaSuccess) return (int)rc;
    const dim3 block(TI, TJ);
    const dim3 grid((args.itot + TI - 1) / TI, (args.jtot + TJ - 1) / TJ);
    tend_rk_fold_kernel<T><<<grid, block, bytes, stream>>>(args);
    return (int)cudaGetLastError();
}

}  // namespace mhh

#define MHH_TEND_RK_FOLD(SUF, T)                                              \
    extern "C" int mhh_tend_rk_fold_##SUF(                                    \
        const void* u, const void* v, const void* w, const void* th,          \
        const void* e_in, const void* se, void* us, void* vs, void* ws,       \
        void* ths, const void* tu_in, const void* tv_in, void* tu_out,        \
        void* tv_out, void* tw, void* tth, void* e_out, void* rhs,            \
        const void* ct, const void* ce, int itot, int jtot, int ktot, int ks, \
        double dxi, double dyi, double visc, double svisc, double tPr,        \
        double cbdt, double can, double dti, double fc, double utrans,        \
        double vtrans, int first, int carry, int coriolis, void* stream) {    \
        mhh::FoldArgs<T> a;                                                   \
        a.u = (const T*)u; a.v = (const T*)v; a.w = (const T*)w;              \
        a.th = (const T*)th; a.e_in = (const T*)e_in; a.se = (const T*)se;    \
        a.us = (T*)us; a.vs = (T*)vs; a.ws = (T*)ws; a.ths = (T*)ths;         \
        a.tu_in = (const T*)tu_in; a.tv_in = (const T*)tv_in;                 \
        a.tu_out = (T*)tu_out; a.tv_out = (T*)tv_out;                         \
        a.tw = (T*)tw; a.tth = (T*)tth; a.e_out = (T*)e_out;                  \
        a.rhs = (T*)rhs; a.ct = (const T*)ct; a.ce = (const T*)ce;            \
        a.itot = itot; a.jtot = jtot; a.ktot = ktot; a.ks = ks;               \
        a.dxi = T(dxi); a.dyi = T(dyi); a.visc = T(visc);                     \
        a.svisc = T(svisc); a.tPr = T(tPr); a.cbdt = T(cbdt);                 \
        a.can = T(can); a.dti = T(dti); a.fc = T(fc);                         \
        a.utrans = T(utrans); a.vtrans = T(vtrans);                           \
        a.first = first; a.carry = carry; a.coriolis = coriolis;              \
        return mhh::launch_tend_rk_fold<T>(a, (cudaStream_t)stream);          \
    }

MHH_TEND_RK_FOLD(f32, float)
MHH_TEND_RK_FOLD(f64, double)
