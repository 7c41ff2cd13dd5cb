// K8/K9, K10, K15, K18 and K19: the tendency sweeps of the generic path
// (any thermo, any scalar list; the moist bomex/rico class), with or without
// the low-storage RK update folded in (s* = s + cB*dt*t_total and the carry
// t = cA_next*t_total).
//
// K8/K9 tend_uvw: u, v and w advec_2 + Smagorinsky diffusion, the column
// fold of the per-substep table (ADDU/V, FACZ, FACZH and the WLSDN/UP
// local-subsidence stencil: sponge, dpdx and large-scale sources, mean
// subsidence) and the geostrophic Coriolis term (force.cxx coriolis_2nd,
// ug/vg from the table).  One kernel for two TPU kernels:
// FusedLES2.tend_uv_rk (microhh_tpu/ops/pallas_fused.py:1617, pallas_call
// :1641; body _tend_uv_rk_body :536) and FusedLES2.tend_w_rk (:1649 /
// :1667; _w_rk_body :401).
//
// K10 and K19, the scalar sweep (scalar_sweep_kernel): every scalar's
// advec_2 + diffusion in one k-march that reads evisc (and u, v, w when it
// advects) once for all of them.  With RK, K10: the column fold (ADDS -
// FACZ a + WLSDN (a - a_dn) + WLSUP (a_up - a)), s* and the scaled carry;
// replaces FusedLES2.tend_scalars_rk (:1702 / :1733; _scalars_rk_body
// :474).  Without, K19: the tendency added onto the carry, no fold, no s*;
// replaces FusedLES2.tend_scalar (:1589 / :1607; _scalar_body :389), which
// the TPU launches once a scalar: here one launch serves up to SW_MAXS
// scalars (the wrappers split the rest over launches).
//
// K15 tend_scalar_rk, one scalar's RK sweep (SBL_Smag's b), is K10's
// launch at S = 1, counted under its own name (ops/fused.py); replaces
// FusedLES2.tend_scalar_rk (:1674 / :1694; _scalar_rk_body :417), with its
// carry, fold and advec flags.  The entry's fold flag is the sweep's FOLD
// template flag (RK's value unless given): off, the column terms of the
// table are left out, a form built at S = 1 only.
//
// advec = 0 leaves the advec_2 terms out: an interpolated scheme (K12/K13,
// advec_interp.cu) has then added the advection into the carry before the
// sweep (pallas_fused.py advec=not self.no_advec); the diffusion, the
// column fold and the Coriolis term stay.  The scalar sweep then reads no
// u, v or w at all (the wrappers pass null pointers).
//
// K18 tend_uvw_acc: K8/K9's sweep WITHOUT the RK fold (the RK template flag
// off), for the substep in which another producer changes the tendency
// after it (open boundaries, sources, the limiter in its tendency form):
// the carry is read, the tendency added, the carry written back in place;
// no s* is written, no ghost level of the carry is touched, the column
// terms of the table are left out (buffer, sources and forcing run as ops
// afterwards) and the Coriolis term stays a flag.  Replaces
// FusedLES2.tend_uv (:1540 / :1560; _tend_uv_body :505) and tend_w (:1568
// / :1582; _w_body :373).  K19 is the scalar sweep's form for that substep.
//
// The fields are ghost-filled and read at k-1 and k+1 as they are (no
// clamping, fold_ghosts off as on the TPU's generic path); evisc is the
// kcells array whose ghost planes repeat the edge levels.  The per-level
// tables are built every substep from plane means (ops/fused.py
// generic_col_tables) and read from device memory on every launch.  The
// carry t always enters: the thermo, microphysics and forcing producers
// have already added to it.  It is updated IN PLACE (carry = 0 on the last
// substep skips the write); s* goes to fresh tensors, because neighbouring
// tiles still read s.  The MOST wall rows are patched afterwards in torch.
//
// Bound: device-memory bytes.  K8/K9 read u, v, w, evisc and the three
// carries and write three s* and three carries: 13 x 4 B per point in f32
// (~3.0 GB per call at 384^3), ~450 flops per point; K18 reads the four
// fields and the carries and writes the carries: 10 x 4 B (2.68 GB at
// 1024x256x256).  Their design (tend_uvw_kernel, one body with RK a
// template flag, on kmarch.cuh): a block of 32 x UVW_TJ threads marches one
// chunk [k0, k1) of the levels of its tile (the chunk count chosen by the
// wrapper, ops/kmarch.py plan).  Level k reads planes k-1, k and k+1 of
// every field across the plane (u's and v's k-1 for w's stencils, w's and
// e's k+1 for u's and v's top faces, e's k-1 for w's face viscosities), so
// group p of the march is plane p of u, v, w and e side by side in one ring
// slot, the four sharing the loader's offsets (16-byte cp.async where the
// tile lies inside the plane), with table row p staged beside it: three
// groups read, one landing, one being filled, UVW_R slots, one commit
// group and one barrier a level.  Each chunk issues group k0-1 first and
// group k1 last, the fields' ghost planes read as they are.  A thread
// keeps its own column (u, v, w, e at k-1 and k, the three carries at k)
// in registers, shifts it by one a level with plane k+1's value from the
// ring, and loads the next carries a level ahead; the staged row's
// quotients (dzi/rho, dzhi/rhoh: les_math.cuh QRow) are divided once a
// level by two threads.  A partial tile computes its virtual points (i >=
// itot or j >= jtot wrap around) like any other and only guards its
// writes; w's tendency is zero at the global level 0 only.
// The scalar sweep with S scalars reads evisc, (u, v, w,) the scalars and
// their carries and writes the carries (and s*): K10 at S = 4 without
// advection 17 fields x 4 B a point (3.85 GB at 384^3), K19 at S = 3
// without advection 10 (2.68 GB at 1024x256x256), ~100 operations a scalar
// and point.  Its design (kmarch.cuh): a block of 32 x SW_TJ threads
// marches one chunk of the levels of its tile (the chunk count chosen by
// the wrapper so that the grid fills the card in whole waves); only plane
// k is read across the plane (the scalars, evisc and, with advection, u's
// i+1 and v's j+1 neighbours), so shared memory holds that plane and the
// two behind it with a halo of one, copied by cp.async two levels ahead
// with one barrier a level; each thread keeps its own column (every
// scalar's and evisc's k-1, k, k+1, w's k and k+1, the carries) in
// registers, the next values loaded one level ahead; the table rows are
// staged in shared memory with the planes; the eddy viscosity at the six
// faces is formed once a point for all scalars.
#include "kmarch.cuh"
#include "les_math.cuh"

#include <type_traits>

namespace mhh {

// ---- the scalar sweep, K10 and K15 (RK) and K19 (no RK) ----

constexpr int SW_TJ = 8;                 // tile rows (32 x SW_TJ threads)
constexpr int SW_NT = km::TI * SW_TJ;
constexpr int SW_HALO = 1;               // the 2nd-order stencil's reach
constexpr int SW_R = 3;                  // ring slots a field: k, k+1, k+2
constexpr int SW_MAXS = 4;               // scalars a launch
constexpr int NTGP = 24;                 // values a staged table row

// the scalars' pointers and viscosities, passed by value
template <typename T>
struct SweepScalars {
    const T* a[SW_MAXS];
    T* as[SW_MAXS];
    T* ta[SW_MAXS];
    T svisc[SW_MAXS];
};

// everything a launch takes but its template arguments
template <typename T>
struct SweepArgs {
    const T *u, *v, *w, *e;
    SweepScalars<T> sc;
    const T* ct;   // K10: (S, ktot, NTG), a table a scalar; K19: (ktot, NTG)
    int itot, jtot, ktot, ks;
    T dxi, dyi, tPri, cbdt, can;
    int carry, chunks, vec_ok;
};

// a field seen from the thread's point: plane k in shared memory (P at the
// point; any offset in the plane but (0, 0)) and the column k-1, k, k+1 in
// registers; s is 0, 1 or 2 for k-1, k, k+1
template <typename T>
struct ColView {
    const T* P;
    T dn, c, up;
    __device__ __forceinline__ T operator()(int s, int dj, int di) const {
        if (s == 0) return dn;
        if (s == 2) return up;
        return dj == 0 && di == 0 ? c : P[dj * km::RS + di];
    }
};

extern __shared__ __align__(16) unsigned char sweep_smem_buf[];

// dynamic shared memory of one launch (ops/kmarch.py repeats it)
template <typename T, bool RK, bool ADV>
constexpr size_t sweep_smem(int S) {
    return ((size_t)(S + 1 + (ADV ? 2 : 0)) * SW_R
                * km::Slot<SW_TJ, SW_HALO>::SIZE
            + (size_t)SW_R * (RK ? S : 1) * NTGP) * sizeof(T);
}

// four blocks an SM in float32 with one or two scalars (at most 64
// registers), three with more; two in float64.  FOLD (RK unless given):
// the column terms of the table; off only in K15's form
template <typename T, bool RK, bool ADV, int S, bool FOLD = RK>
__global__ void __launch_bounds__(SW_NT,
                                  sizeof(T) == 4 ? (S <= 2 ? 4 : 3) : 2)
scalar_sweep_kernel(const SweepArgs<T> p) {
    using Sl = km::Slot<SW_TJ, SW_HALO>;
    constexpr int NF = S + 1 + (ADV ? 2 : 0);   // scalars, e, (u, v)
    constexpr int NR = RK ? S : 1;               // table rows a level
    T* const ring = reinterpret_cast<T*>(sweep_smem_buf);
    T* const rows = ring + NF * SW_R * Sl::SIZE;
    const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * km::TI + tx;
    const int i0 = blockIdx.x * km::TI, j0 = blockIdx.y * SW_TJ;
    const int i = i0 + tx, j = j0 + ty;
    const bool inside = i < p.itot && j < p.jtot;
    int k0, k1;
    km::chunk_bounds(blockIdx.z, p.chunks, p.ktot, k0, k1);
    const long long plane = (long long)p.itot * p.jtot;
    const km::PlaneLoader<T, SW_TJ, SW_NT, SW_HALO> ld(
        tid, i0, j0, p.itot, p.jtot, p.vec_ok && i0 + km::TI <= p.itot);
    // the point, wrapped where the tile passes the plane's edge (only its
    // stores are guarded)
    const long long o2 = (long long)wrap(j, p.jtot) * p.itot + wrap(i, p.itot);
    const int me = (ty + SW_HALO) * km::RS + tx + km::C0;
    auto level = [&](int k) { return (long long)(p.ks + k) * plane; };
    const Slots q{0, 1, 2};
    // field f's slot of plane k: the scalars 0..S-1, e S, u S+1, v S+2
    auto slot = [&](int f, int k) {
        return ring + (f * SW_R + k % SW_R) * Sl::SIZE;
    };

    // group k: plane k of every field and the table row(s) k; none past
    // the chunk (an empty group keeps the count)
    auto issue = [&](int k) {
        if (k < k1) {
            const long long lev = level(k);
#pragma unroll
            for (int n = 0; n < S; ++n) ld.issue(slot(n, k), p.sc.a[n] + lev);
            ld.issue(slot(S, k), p.e + lev);
            if (ADV) {
                ld.issue(slot(S + 1, k), p.u + lev);
                ld.issue(slot(S + 2, k), p.v + lev);
            }
            if (tid < NR * NTG) {
                const int n = tid / NTG, c = tid - n * NTG;
                km::cp_async<sizeof(T)>(
                    rows + ((k % SW_R) * NR + n) * NTGP + c,
                    p.ct + ((long long)n * p.ktot + k) * NTG + c);
            }
        }
        km::commit();
    };

    // the register columns: a and e at k-1, k, k+1, w at k and k+1, the
    // carries at k
    T a0[S], a1[S], a2[S], tc[S];
#pragma unroll
    for (int n = 0; n < S; ++n) {
        a0[n] = __ldg(p.sc.a[n] + level(k0 - 1) + o2);
        a1[n] = __ldg(p.sc.a[n] + level(k0) + o2);
        a2[n] = __ldg(p.sc.a[n] + level(k0 + 1) + o2);
        tc[n] = p.sc.ta[n][level(k0) + o2];
    }
    T e0 = __ldg(p.e + level(k0 - 1) + o2), e1 = __ldg(p.e + level(k0) + o2);
    T e2 = __ldg(p.e + level(k0 + 1) + o2);
    T w0 = T(0), w1 = T(0);
    if (ADV) {
        w0 = __ldg(p.w + level(k0) + o2);
        w1 = __ldg(p.w + level(k0 + 1) + o2);
    }

    issue(k0);
    issue(k0 + 1);
    for (int k = k0; k < k1; ++k) {
        km::wait_pending<1>();
        __syncthreads();
        issue(k + 2);
        // what the next level needs, on its way during this one's work
        const long long ln = level(min(k + 2, k1)), lt = level(min(k + 1, k1 - 1));
        T an[S], tn[S];
#pragma unroll
        for (int n = 0; n < S; ++n) {
            an[n] = __ldg(p.sc.a[n] + ln + o2);
            tn[n] = p.sc.ta[n][lt + o2];
        }
        const T en = __ldg(p.e + ln + o2);
        const T wn = ADV ? __ldg(p.w + ln + o2) : T(0);

        const ColView<T> E{slot(S, k) + me, e0, e1, e2};
        T f[6];
        s_faces(E, q, f);
        const T* pu = ADV ? slot(S + 1, k) + me : nullptr;
        const T* pv = ADV ? slot(S + 2, k) + me : nullptr;
        const ColView<T> U{pu, T(0), ADV ? pu[0] : T(0), T(0)};
        const ColView<T> V{pv, T(0), ADV ? pv[0] : T(0), T(0)};
        const ColView<T> W{nullptr, T(0), w0, w1};
        const T* rk = rows + (k % SW_R) * NR * NTGP;
        const long long o = level(k) + o2;
#pragma unroll
        for (int n = 0; n < S; ++n) {
            const T* cc = rk + (RK ? n * NTGP : 0);
            const ColView<T> A{slot(n, k) + me, a0[n], a1[n], a2[n]};
            const T adv = ADV ? s_adv(U, V, W, A, q, cc, p.dxi, p.dyi) : T(0);
            T tt = tc[n] + (adv + s_dif(A, q, cc, p.dxi, p.dyi, f, p.tPri,
                                        p.sc.svisc[n]));
            if (RK) {
                const T a_ = a1[n];
                if (FOLD)
                    tt = tt + (cc[T_ADDS] - cc[T_FACZ] * a_
                               + cc[T_WLSDN] * (a_ - a0[n])
                               + cc[T_WLSUP] * (a2[n] - a_));
                if (inside) {
                    p.sc.as[n][o] = a_ + p.cbdt * tt;
                    if (p.carry) p.sc.ta[n][o] = p.can * tt;
                }
            } else if (inside) {
                p.sc.ta[n][o] = tt;
            }
        }
#pragma unroll
        for (int n = 0; n < S; ++n) {
            a0[n] = a1[n];
            a1[n] = a2[n];
            a2[n] = an[n];
            tc[n] = tn[n];
        }
        e0 = e1; e1 = e2; e2 = en;
        w0 = w1; w1 = wn;
    }
    // no copy may land after the block has left its shared memory
    km::wait_all();
}

// f(integral_constant ADV, integral_constant S, integral_constant FOLD) for
// the form (advec, S, fold): K10's and K19's forms fold as RK says; K15's
// form without the fold (RK, fold 0) is built at S = 1 only
template <bool RK, typename F>
int sweep_form(int advec, int S, int fold, F f) {
    using std::integral_constant;
    using Y = integral_constant<bool, true>;
    using N = integral_constant<bool, false>;
    using R = integral_constant<bool, RK>;
    using One = integral_constant<int, 1>;
    if (RK && !fold) {
        if (S != 1) return (int)cudaErrorInvalidValue;
        return advec ? f(Y(), One(), N()) : f(N(), One(), N());
    }
    switch (S * 2 + (advec ? 1 : 0)) {
    case 2: return f(N(), One(), R());
    case 3: return f(Y(), One(), R());
    case 4: return f(N(), integral_constant<int, 2>(), R());
    case 5: return f(Y(), integral_constant<int, 2>(), R());
    case 6: return f(N(), integral_constant<int, 3>(), R());
    case 7: return f(Y(), integral_constant<int, 3>(), R());
    case 8: return f(N(), integral_constant<int, 4>(), R());
    case 9: return f(Y(), integral_constant<int, 4>(), R());
    }
    return (int)cudaErrorInvalidValue;
}

template <typename T, bool RK>
int scalar_sweep(const T* u, const T* v, const T* w, const T* e,
                 const void* const* a, void* const* as, void* const* ta,
                 const double* svisc, int S, const T* ct, int itot, int jtot,
                 int ktot, int ks, double dxi, double dyi, double tPr,
                 double cbdt, double can, int carry, int fold, int advec,
                 int chunks, cudaStream_t stream) {
    if (S < 1 || S > SW_MAXS || chunks < 1 || chunks > ktot)
        return (int)cudaErrorInvalidValue;
    if (advec && !(u && v && w)) return (int)cudaErrorInvalidValue;
    SweepArgs<T> p;
    p.u = advec ? u : nullptr;
    p.v = advec ? v : nullptr;
    p.w = advec ? w : nullptr;
    p.e = e;
    bool vec = itot % (16 / (int)sizeof(T)) == 0 && km::aligned16(e)
               && (!advec || (km::aligned16(u) && km::aligned16(v)));
    for (int n = 0; n < SW_MAXS; ++n) {
        const bool used = n < S;
        p.sc.a[n] = used ? (const T*)a[n] : nullptr;
        p.sc.as[n] = used && RK ? (T*)as[n] : nullptr;
        p.sc.ta[n] = used ? (T*)ta[n] : nullptr;
        p.sc.svisc[n] = used ? T(svisc[n]) : T(0);
        if (used) vec = vec && km::aligned16(a[n]);
    }
    p.ct = ct;
    p.itot = itot; p.jtot = jtot; p.ktot = ktot; p.ks = ks;
    p.dxi = T(dxi); p.dyi = T(dyi); p.tPri = T(1) / T(tPr);
    p.cbdt = T(cbdt); p.can = T(can);
    p.carry = carry; p.chunks = chunks; p.vec_ok = (int)vec;
    return sweep_form<RK>(advec, S, fold, [&](auto adv, auto s, auto fo) {
        constexpr bool ADV = decltype(adv)::value;
        constexpr int SS = decltype(s)::value;
        auto kernel = scalar_sweep_kernel<T, RK, ADV, SS, decltype(fo)::value>;
        const size_t smem = sweep_smem<T, RK, ADV>(SS);
        int rc = (int)cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (rc) return rc;
        const dim3 block(km::TI, SW_TJ);
        const dim3 grid((itot + km::TI - 1) / km::TI,
                        (jtot + SW_TJ - 1) / SW_TJ, chunks);
        kernel<<<grid, block, smem, stream>>>(p);
        return (int)cudaGetLastError();
    });
}

template <typename T, bool RK>
int scalar_sweep_info(int advec, int S, int fold, int* out) {
    return sweep_form<RK>(advec, S, fold, [&](auto adv, auto s, auto fo) {
        constexpr bool ADV = decltype(adv)::value;
        constexpr int SS = decltype(s)::value;
        return km::kernel_info(
            scalar_sweep_kernel<T, RK, ADV, SS, decltype(fo)::value>, SW_NT,
            sweep_smem<T, RK, ADV>(SS), out);
    });
}

// ---- the momentum sweep, K8/K9 (RK) and K18 (no RK) ----

constexpr int UVW_TJ = 8;                // tile rows (32 x UVW_TJ threads)
constexpr int UVW_NT = km::TI * UVW_TJ;
constexpr int UVW_HALO = 1;              // the 2nd-order stencil's reach
constexpr int UVW_NF = 4;                // fields a group: u, v, w, e
constexpr int UVW_R = 5;                 // group slots: k-1 .. k+3

// everything a launch takes but its template argument
template <typename T>
struct UvwArgs {
    const T *u, *v, *w, *e;
    T *us, *vs, *ws;      // s*, null without RK
    T *tu, *tv, *tw;      // the carries, in place
    const T* ct;          // (ktot, NTG)
    int itot, jtot, ktot, ks;
    T dxi, dyi, visc, fc, utrans, vtrans, cbdt, can;
    int coriolis, carry, advec, chunks, vec_ok;
};

// dynamic shared memory of one launch (ops/kmarch.py repeats it): UVW_R
// groups of the four fields' planes and a staged table row a group
template <typename T>
constexpr size_t uvw_smem() {
    return ((size_t)UVW_R * UVW_NF * km::Slot<UVW_TJ, UVW_HALO>::SIZE
            + (size_t)UVW_R * NTGP) * sizeof(T);
}

extern __shared__ __align__(16) unsigned char uvw_smem_buf[];

// three blocks an SM for K8/K9 in float32 (at most 80 registers), four
// for K18 (at most 64: 1.098 against 1.179 ms at jaenschwalde, while K8/K9
// read 1.285 against 1.273 at rico 384^3 on an H100 at 700 W), two in
// float64
template <typename T, bool RK>
__global__ void __launch_bounds__(UVW_NT, sizeof(T) == 4 ? (RK ? 3 : 4) : 2)
tend_uvw_kernel(const UvwArgs<T> a) {
    using Sl = km::Slot<UVW_TJ, UVW_HALO>;
    constexpr int SZ = Sl::SIZE, PL = UVW_NF * SZ;
    T* const ring = reinterpret_cast<T*>(uvw_smem_buf);   // [R][NF][SZ]
    T* const rows = ring + UVW_R * PL;                     // [R][NTGP]
    const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * km::TI + tx;
    const int i0 = blockIdx.x * km::TI, j0 = blockIdx.y * UVW_TJ;
    const bool inside = i0 + tx < a.itot && j0 + ty < a.jtot;
    int k0, k1;
    km::chunk_bounds(blockIdx.z, a.chunks, a.ktot, k0, k1);
    const long long plane = (long long)a.itot * a.jtot;
    const km::PlaneLoader<T, UVW_TJ, UVW_NT, UVW_HALO> ld(
        tid, i0, j0, a.itot, a.jtot, a.vec_ok && i0 + km::TI <= a.itot);
    // the point, wrapped where the tile passes the plane's edge (only its
    // stores are guarded), in the plane and in a slot
    const long long o2 =
        (long long)wrap(j0 + ty, a.jtot) * a.itot + wrap(i0 + tx, a.itot);
    const int me = (ty + UVW_HALO) * km::RS + tx + km::C0;
    auto level = [&](int k) { return (long long)(a.ks + k) * plane; };
    auto next = [](int s) { return s == UVW_R - 1 ? 0 : s + 1; };

    // group p into slot s: plane p of u, v, w and e (the loader's offsets
    // shared by the four) and, for a level of the chunk, table row p; none
    // past plane k1 (an empty group keeps the count)
    auto issue = [&](int p, int s) {
        if (p <= k1) {
            const long long lev = level(p);
            T* const sl = ring + s * PL;
#pragma unroll
            for (int n = 0; n < ld.NOP; ++n) {
                if (ld.src[n] < 0) continue;
                T* const d = sl + (ld.dst[n] & (km::VEC - 1));
                const long long g = lev + ld.src[n];
                if (ld.dst[n] & km::VEC) {
                    km::cp_async<16>(d, a.u + g);
                    km::cp_async<16>(d + SZ, a.v + g);
                    km::cp_async<16>(d + 2 * SZ, a.w + g);
                    km::cp_async<16>(d + 3 * SZ, a.e + g);
                } else {
                    km::cp_async<sizeof(T)>(d, a.u + g);
                    km::cp_async<sizeof(T)>(d + SZ, a.v + g);
                    km::cp_async<sizeof(T)>(d + 2 * SZ, a.w + g);
                    km::cp_async<sizeof(T)>(d + 3 * SZ, a.e + g);
                }
            }
            if (p >= k0 && p < k1 && tid < NTG)
                km::cp_async<sizeof(T)>(rows + s * NTGP + tid,
                                        a.ct + (long long)p * NTG + tid);
        }
        km::commit();
    };
    // the quotients of the staged row in slot s (QRow's columns), divided
    // as the point functions would divide them, by two threads
    auto derive = [&](int s) {
        T* const r = rows + s * NTGP;
        if (tid == 0) r[TQ_RDZI] = r[T_DZI] / r[T_RHO];
        else if (tid == 1) r[TQ_RDZHI] = r[T_DZHI] / r[T_RHOH];
    };

    // group p lives in slot (p - k0 + 1) mod UVW_R
    issue(k0 - 1, 0);
    issue(k0, 1);
    issue(k0 + 1, 2);
    issue(k0 + 2, 3);
    km::wait_pending<2>();      // groups k0-1 and k0 have landed
    __syncthreads();
    derive(1);
    // the register columns at k0-1 and k0, the carries at k0
    T u0 = ring[me], v0 = ring[me + SZ], w0 = ring[me + 2 * SZ];
    T e0 = ring[me + 3 * SZ];
    T u1 = ring[PL + me], v1 = ring[PL + me + SZ];
    T w1 = ring[PL + me + 2 * SZ], e1 = ring[PL + me + 3 * SZ];
    T cu = a.tu[level(k0) + o2], cv = a.tv[level(k0) + o2];
    T cw = a.tw[level(k0) + o2];
    const Slots q{0, 1, 2};
    int sm = 0;                 // the slot of group k-1
    for (int k = k0; k < k1; ++k) {
        km::wait_pending<1>();  // group k+1 has landed
        __syncthreads();
        const int sc = next(sm), sp = next(sc);
        // group k+3 goes where group k-2 lay, which nothing reads any more
        issue(k + 3, sm == 0 ? UVW_R - 1 : sm - 1);
        // the quotients of row k+1, which landed with its group
        if (k + 1 < k1) derive(sp);
        // the carries of the next level, on their way during this one
        const long long ln = level(min(k + 1, k1 - 1)) + o2;
        const T cun = a.tu[ln], cvn = a.tv[ln], cwn = a.tw[ln];

        const T* const pm = ring + sm * PL + me;
        const T* const pc = ring + sc * PL + me;
        const T* const pp = ring + sp * PL + me;
        const T u2 = pp[0], v2 = pp[SZ], w2 = pp[2 * SZ], e2 = pp[3 * SZ];
        const KV<T, km::RS> U{pm, pc, pp, u0, u1, u2};
        const KV<T, km::RS> V{pm + SZ, pc + SZ, pp + SZ, v0, v1, v2};
        const KV<T, km::RS> W{pm + 2 * SZ, pc + 2 * SZ, pp + 2 * SZ,
                              w0, w1, w2};
        const KV<T, km::RS> E{pm + 3 * SZ, pc + 3 * SZ, pp + 3 * SZ,
                              e0, e1, e2};
        const QRow<T> cc{rows + sc * NTGP};
        T ut = u_tend<QRow<T>>(U, V, W, E, q, cc, a.dxi, a.dyi, a.visc,
                               a.advec);
        T vt = v_tend<QRow<T>>(U, V, W, E, q, cc, a.dxi, a.dyi, a.visc,
                               a.advec);
        T wt = w_tend<QRow<T>>(U, V, W, E, q, cc, a.dxi, a.dyi, a.visc,
                               a.advec);

        // ---- column fold and Coriolis (pallas_fused.py _extra_uv) ----
        if (RK) {
            const T facz = cc[T_FACZ];
            ut = ut + cc[T_ADDU] - facz * u1;
            vt = vt + cc[T_ADDV] - facz * v1;
            const T wdn = cc[T_WLSDN], wup = cc[T_WLSUP];
            ut = ut + wdn * (u1 - u0) + wup * (u2 - u1);
            vt = vt + wdn * (v1 - v0) + wup * (v2 - v1);
            wt = wt - cc[T_FACZH] * w1;
        }
        if (a.coriolis) {
            // the JAX package's stencil (ROADMAP "followed behaviour" 1)
            const T v_at_u = T(0.25) * (v1 + V(1, 0, 1) + V(1, -1, 0)
                                        + V(1, -1, 1));
            const T u_at_v = T(0.25) * (u1 + U(1, 0, -1) + U(1, 1, 0)
                                        + U(1, 1, -1));
            ut = ut + a.fc * (v_at_u + a.vtrans - cc[T_VG]);
            vt = vt - a.fc * (u_at_v + a.utrans - cc[T_UG]);
        }
        if (k == 0) wt = T(0);   // half level ks is the wall

        // ---- RK fold, or the plain accumulation onto the carry ----
        ut = cu + ut;
        vt = cv + vt;
        wt = cw + wt;
        if (inside) {
            const long long o = level(k) + o2;
            if (RK) {
                a.us[o] = u1 + a.cbdt * ut;
                a.vs[o] = v1 + a.cbdt * vt;
                a.ws[o] = w1 + a.cbdt * wt;
                if (a.carry) {
                    a.tu[o] = a.can * ut;
                    a.tv[o] = a.can * vt;
                    a.tw[o] = a.can * wt;
                }
            } else {
                a.tu[o] = ut;
                a.tv[o] = vt;
                a.tw[o] = wt;
            }
        }
        u0 = u1; u1 = u2;
        v0 = v1; v1 = v2;
        w0 = w1; w1 = w2;
        e0 = e1; e1 = e2;
        cu = cun; cv = cvn; cw = cwn;
        sm = sc;
    }
    // no copy may land after the block has left its shared memory
    km::wait_all();
}

template <typename T, bool RK>
int launch_tend_uvw(const UvwArgs<T>& args, cudaStream_t stream) {
    if (args.chunks < 1 || args.chunks > args.ktot)
        return (int)cudaErrorInvalidValue;
    const size_t smem = uvw_smem<T>();
    int rc = (int)cudaFuncSetAttribute(
        tend_uvw_kernel<T, RK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (rc) return rc;
    const dim3 block(km::TI, UVW_TJ);
    const dim3 grid((args.itot + km::TI - 1) / km::TI,
                    (args.jtot + UVW_TJ - 1) / UVW_TJ, args.chunks);
    tend_uvw_kernel<T, RK><<<grid, block, smem, stream>>>(args);
    return (int)cudaGetLastError();
}

// the arguments of one launch; us, vs, ws null without RK
template <typename T>
UvwArgs<T> uvw_args(const void* u, const void* v, const void* w,
                    const void* e, void* us, void* vs, void* ws, void* tu,
                    void* tv, void* tw, const void* ct, int itot, int jtot,
                    int ktot, int ks, double dxi, double dyi, double visc,
                    double fc, double utrans, double vtrans, double cbdt,
                    double can, int coriolis, int carry, int advec,
                    int chunks) {
    UvwArgs<T> a;
    a.u = (const T*)u; a.v = (const T*)v; a.w = (const T*)w;
    a.e = (const T*)e;
    a.us = (T*)us; a.vs = (T*)vs; a.ws = (T*)ws;
    a.tu = (T*)tu; a.tv = (T*)tv; a.tw = (T*)tw;
    a.ct = (const T*)ct;
    a.itot = itot; a.jtot = jtot; a.ktot = ktot; a.ks = ks;
    a.dxi = T(dxi); a.dyi = T(dyi); a.visc = T(visc); a.fc = T(fc);
    a.utrans = T(utrans); a.vtrans = T(vtrans);
    a.cbdt = T(cbdt); a.can = T(can);
    a.coriolis = coriolis; a.carry = carry; a.advec = advec;
    a.chunks = chunks;
    a.vec_ok = itot % (16 / (int)sizeof(T)) == 0 && km::aligned16(u)
               && km::aligned16(v) && km::aligned16(w) && km::aligned16(e);
    return a;
}

}  // namespace mhh

#define MHH_TEND_GENERIC(SUF, T)                                              \
    extern "C" int mhh_tend_uvw_##SUF(                                        \
        const void* u, const void* v, const void* w, const void* e,           \
        void* us, void* vs, void* ws, void* tu, void* tv, void* tw,           \
        const void* ct, int itot, int jtot, int ktot, int ks, double dxi,     \
        double dyi, double visc, double fc, double utrans, double vtrans,      \
        double cbdt, double can, int coriolis, int carry, int advec,          \
        int chunks, void* stream) {                                           \
        return mhh::launch_tend_uvw<T, true>(                                 \
            mhh::uvw_args<T>(u, v, w, e, us, vs, ws, tu, tv, tw, ct, itot,    \
                             jtot, ktot, ks, dxi, dyi, visc, fc, utrans,      \
                             vtrans, cbdt, can, coriolis, carry, advec,       \
                             chunks),                                         \
            (cudaStream_t)stream);                                            \
    }                                                                         \
    extern "C" int mhh_tend_uvw_info_##SUF(int scheme, int S, int* out) {     \
        return mhh::km::kernel_info(mhh::tend_uvw_kernel<T, true>,            \
                                    mhh::UVW_NT, mhh::uvw_smem<T>(), out);    \
    }                                                                         \
    extern "C" int mhh_tend_scalars_##SUF(                                    \
        const void* u, const void* v, const void* w, const void* e,           \
        const void* const* a, void* const* as, void* const* ta,               \
        const double* svisc, int S, const void* cts, int itot, int jtot,      \
        int ktot, int ks, double dxi, double dyi, double tPr, double cbdt,    \
        double can, int carry, int fold, int advec, int chunks,               \
        void* stream) {                                                       \
        return mhh::scalar_sweep<T, true>(                                    \
            (const T*)u, (const T*)v, (const T*)w, (const T*)e, a, as, ta,    \
            svisc, S, (const T*)cts, itot, jtot, ktot, ks, dxi, dyi, tPr,     \
            cbdt, can, carry, fold, advec, chunks, (cudaStream_t)stream);     \
    }                                                                         \
    extern "C" int mhh_tend_scalars_info_##SUF(int scheme, int S, int* out) { \
        return mhh::scalar_sweep_info<T, true>(scheme & 1, S, !(scheme & 2),  \
                                               out);                          \
    }                                                                         \
    extern "C" int mhh_tend_uvw_acc_##SUF(                                    \
        const void* u, const void* v, const void* w, const void* e,           \
        void* tu, void* tv, void* tw, const void* ct, int itot, int jtot,     \
        int ktot, int ks, double dxi, double dyi, double visc, double fc,     \
        double utrans, double vtrans, int coriolis, int advec, int chunks,    \
        void* stream) {                                                       \
        return mhh::launch_tend_uvw<T, false>(                                \
            mhh::uvw_args<T>(u, v, w, e, nullptr, nullptr, nullptr, tu, tv,  \
                             tw, ct, itot, jtot, ktot, ks, dxi, dyi, visc,    \
                             fc, utrans, vtrans, 0., 0., coriolis, 0, advec,  \
                             chunks),                                         \
            (cudaStream_t)stream);                                            \
    }                                                                         \
    extern "C" int mhh_tend_uvw_acc_info_##SUF(int scheme, int S,             \
                                               int* out) {                    \
        return mhh::km::kernel_info(mhh::tend_uvw_kernel<T, false>,           \
                                    mhh::UVW_NT, mhh::uvw_smem<T>(), out);    \
    }                                                                         \
    extern "C" int mhh_tend_scalar_acc_##SUF(                                 \
        const void* u, const void* v, const void* w, const void* e,           \
        const void* const* a, void* const* ta, const double* svisc, int S,    \
        const void* ct, int itot, int jtot, int ktot, int ks, double dxi,     \
        double dyi, double tPr, int advec, int chunks, void* stream) {        \
        return mhh::scalar_sweep<T, false>(                                   \
            (const T*)u, (const T*)v, (const T*)w, (const T*)e, a, nullptr,   \
            ta, svisc, S, (const T*)ct, itot, jtot, ktot, ks, dxi, dyi, tPr,  \
            0., 0., 0, 0, advec, chunks, (cudaStream_t)stream);               \
    }                                                                         \
    extern "C" int mhh_tend_scalar_acc_info_##SUF(int advec, int S,           \
                                                  int* out) {                 \
        return mhh::scalar_sweep_info<T, false>(advec, S, 0, out);            \
    }

MHH_TEND_GENERIC(f32, float)
MHH_TEND_GENERIC(f64, double)
