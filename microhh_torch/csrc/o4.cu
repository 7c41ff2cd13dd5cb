// K16 and K17: the 4th-order DNS stack's advection (advec_4 or advec_4m)
// plus diffusion (diff_4) added into the RK carry in one pass per field
// group (reference src/advec_4.cxx, src/advec_4m.cxx, src/diff_4.cxx).
//
// K16 o4_mom: tu, tv, tw += advection of (u, v, w with conservation-type
// ghosts) + visc * diffusion of (u, v, w with plain ghosts).  Replaces the
// momentum call of O4FusedPallas._core (microhh_tpu/ops/o4_pallas.py:391,
// pallas_call :408; body _o4_mom_body :252).
// K17 o4_scalars: each of S scalars' carry += its advection + svisc * its
// diffusion, with u, v and four w planes read once for all of them.
// Replaces the scalar call (:435; body _o4_scalar_body :319).
//
// Horizontal: 4-tap interpolations (ci) and flux divergences (cg) chained
// to a reach of i +- 3 and j +- 3, and the 7-point second derivative (cdg),
// all periodic.  Vertical: the fields are ghost-filled to three levels, so
// planes k-3..k+3 are read as they are; row r of the table cc
// (ops/o4_fused.py build_o4_tables) holds six tap weights of the
// interpolation and of the gradient (metric folded in) at one half level
// (cell family) or centre (w family), with the bi/ti/bg/tg wall rows, so a
// tap that a wall row does not use has weight zero.  The 4m scheme (M)
// replaces the interpolated fluxes by velocity times two-point means, with
// mirrored fluxes at the walls.
//
// Bound: K16 reads u, v, both w and reads and writes three carries, 10 x
// 4 B a point in f32.  As written here it does about 560 operations a point
// (510 in 4m; 840 and 640 when every thread computed each face interpolant
// it used), so the bytes bind on an H100.  K17 reads 3 + 2S fields and
// writes S, about 215 operations a scalar and point (130 in 4m).
// K17's design (K12's): a block of OI x OJ threads owns an (OJ, OI) tile and
// marches through all of k; each scalar keeps a ring of seven (OJ+6) x
// (OI+6) planes (tile + 3-cell periodic halo) in dynamic shared memory,
// loaded synchronously, and u, v (i-1..i+2, j-1..j+2) and w (k-1..k+2) come
// straight from global memory; the wrapper splits the scalars over launches
// when their rings exceed a block's shared memory.
// K16's design (kmarch.cuh): a block of 32 x K16_TJ threads marches one
// chunk of the levels of its tile, the chunk count chosen by the wrapper so
// that the grid fills the card in whole waves.  Shared memory holds only
// the planes read across the plane (U and V at k-2..k+1, WC at k and k+2,
// WD at k), copied by cp.async D levels ahead, and the eight face
// interpolants of the tile and its flux halo, each computed once per point
// and read by the four neighbours that use it (a second barrier a level);
// each thread keeps its own column, planes k-3..k+3 of the four fields, and
// w interpolated to its u and v points at half levels k-1..k+2, in
// registers, shifted by one a level.  The table rows come into shared
// memory with the planes.  The carries are updated in place, each point
// and level by one block.
#include "kmarch.cuh"

namespace mhh {
namespace o4 {

// table columns (ops/o4_fused.py)
enum { TXA = 0, TG = 6, TWC = 12, TGW = 18, DZI4 = 24, DZHI4 = 25, WMASK = 26,
       NC = 27 };

constexpr int OI = 32;
constexpr int OJ = 16;
constexpr int OH = 3;
constexpr int WI = OI + 2 * OH;
constexpr int WJ = OJ + 2 * OH;
constexpr int NR = 7;
constexpr int MAXS = 8;

extern __shared__ __align__(16) unsigned char o4_smem[];

__device__ __forceinline__ int slot7(int p) { return (p + NR) % NR; }

template <typename T>
__device__ __forceinline__ void load_tile7(T (*sh)[WI], const T* __restrict__ a,
                                           long long level, int j0, int i0,
                                           int jtot, int itot) {
    const long long base = level * (long long)jtot * itot;
    for (int idx = threadIdx.y * OI + threadIdx.x; idx < WJ * WI;
         idx += OI * OJ) {
        const int r = idx / WI;
        const int c = idx - r * WI;
        const int jg = wrap(j0 + r - OH, jtot);
        const int ig = wrap(i0 + c - OH, itot);
        sh[r][c] = __ldg(a + base + (long long)jg * itot + ig);
    }
}

// one field's seven-plane ring seen from the thread's point
template <typename T>
struct View7 {
    const T (*ring)[WJ][WI];
    int r, c;
    __device__ __forceinline__ T operator()(int s, int dj, int di) const {
        return ring[s][r + dj][c + di];
    }
};

template <typename T>
__device__ __forceinline__ View7<T> view7(const T (*ring)[WJ][WI]) {
    return View7<T>{ring, (int)threadIdx.y + OH, (int)threadIdx.x + OH};
}

// ci interpolation and cg gradient of four consecutive values
template <typename T>
__device__ __forceinline__ T interp4(T a, T b, T c, T d) {
    return T(-1. / 16.) * a + T(9. / 16.) * b + T(9. / 16.) * c
           + T(-1. / 16.) * d;
}

template <typename T>
__device__ __forceinline__ T grad4(T a, T b, T c, T d) {
    return T(1. / 24.) * a + T(-27. / 24.) * b + T(27. / 24.) * c
           + T(-1. / 24.) * d;
}

// plane s of Q interpolated to i-1/2 (ixh) or j-1/2 (jyh) at offset (dj, di)
template <typename T>
__device__ __forceinline__ T ixh(const View7<T>& Q, int s, int dj, int di) {
    return interp4(Q(s, dj, di - 2), Q(s, dj, di - 1), Q(s, dj, di),
                   Q(s, dj, di + 1));
}

template <typename T>
__device__ __forceinline__ T jyh(const View7<T>& Q, int s, int dj, int di) {
    return interp4(Q(s, dj - 2, di), Q(s, dj - 1, di), Q(s, dj, di),
                   Q(s, dj + 1, di));
}

// flux divergence along one axis: f(d) is the flux at offset d - 1/2
template <typename T, typename F>
__device__ __forceinline__ T div4(F f) {
    return grad4<T>(f(-1), f(0), f(1), f(2));
}

// the 4m form along one axis: vel(d) the advecting velocity at offset
// d - 1/2, q(d) the transported quantity at offset d
template <typename T, typename FV, typename FQ>
__device__ __forceinline__ T flux4(FV vel, FQ q) {
    const T h = T(0.5), q0 = q(0);
    const T a = vel(-1) * h * (q(-3) + q0);
    const T b = vel(0) * h * (q(-1) + q0);
    const T c = vel(1) * h * (q0 + q(1));
    const T d = vel(2) * h * (q0 + q(3));
    return T(1. / 24.) * (d - a) + T(-27. / 24.) * (c - b);
}

// 7-point horizontal second derivative of plane s at the point
template <typename T>
__device__ __forceinline__ T lap_h(const View7<T>& Q, int s, T dxidxi,
                                   T dyidyi) {
    const T c0 = T(-1460. / 576.), c1 = T(783. / 576.), c2 = T(-54. / 576.),
            c3 = T(1. / 576.);
    const T q0 = Q(s, 0, 0);
    return (c3 * (Q(s, 0, -3) + Q(s, 0, 3)) + c2 * (Q(s, 0, -2) + Q(s, 0, 2))
            + c1 * (Q(s, 0, -1) + Q(s, 0, 1)) + c0 * q0) * dxidxi
           + (c3 * (Q(s, -3, 0) + Q(s, 3, 0)) + c2 * (Q(s, -2, 0) + Q(s, 2, 0))
              + c1 * (Q(s, -1, 0) + Q(s, 1, 0)) + c0 * q0) * dyidyi;
}

// Cell family: sum_e cg_e * V_e * X_e with X_e the six-tap row at half level
// k-1+e (table row k+e) applied to the column q[0..6] = planes k-3..k+3;
// vel = nullptr gives the gradient (diffusion) form.  Taps outside the
// window have zero weight by construction and are skipped.
template <typename T>
__device__ __forceinline__ T vd_cell(const T* __restrict__ cc, int k, int base,
                                     const T* q, const T* vel) {
    T x[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
        const T* row = cc + (long long)(k + e) * NC + base;
        T acc = T(0);
#pragma unroll
        for (int d = -3; d < 3; ++d) {
            const int off = e - 1 + d;
            if (off < -3 || off > 3) continue;
            acc = acc + row[d + 3] * q[off + 3];
        }
        x[e] = vel ? vel[e] * acc : acc;
    }
    return grad4(x[0], x[1], x[2], x[3]);
}

// 4m, cell target at level k: -grad4 of the half-position fluxes, with the
// mirrored negative outer flux at the walls; wv[e] at half level k-1+e
template <typename T>
__device__ __forceinline__ T vert4m_cell(int k, int kt, const T* q,
                                         const T* wv) {
    const T h = T(0.5), q0 = q[3];
    T a = wv[0] * h * (q[0] + q0);
    const T b = wv[1] * h * (q[2] + q0);
    const T c = wv[2] * h * (q0 + q[4]);
    T d = wv[3] * h * (q0 + q[6]);
    if (k == 0) a = -wv[2] * h * (q[2] + q[5]);
    if (k == kt - 1) d = -wv[1] * h * (q[1] + q[4]);
    return T(1. / 24.) * (d - a) + T(-27. / 24.) * (c - b);
}

// 4m, w target at half level k: centre-located fluxes
template <typename T>
__device__ __forceinline__ T vert4m_w(const T* w) {
    const T h = T(0.5), w0 = w[3];
    const T a = interp4(w[0], w[1], w[2], w[3]) * h * (w[0] + w0);
    const T b = interp4(w[1], w[2], w[3], w[4]) * h * (w[2] + w0);
    const T c = interp4(w[2], w[3], w[4], w[5]) * h * (w0 + w[4]);
    const T d = interp4(w[3], w[4], w[5], w[6]) * h * (w0 + w[6]);
    return T(1. / 24.) * (d - a) + T(-27. / 24.) * (c - b);
}

// K16's k-march (kmarch.cuh): 32 x K16_TJ tiles, D(T) levels of prefetch.
// U and V: planes k-2..k+1 read across the plane (u and v to the half
// level at the halo points); WC: planes k (the w equation) and k+2 (its
// newest interpolants to the u and v points); WD: plane k (the Laplacian).
// Eight interpolant planes of the tile and its flux halo: ixh and jyh of u
// and v at level k, ixh and jyh of w at half level k, u and v interpolated
// to half level k.  Eight staged table rows (k-1..k+3 read).
constexpr int K16_TJ = 8;
constexpr int K16_NT = km::TI * K16_TJ;
enum { IXU = 0, JYU, IXV, JYV, IXW, JYW, UZ, VZ, NI };

template <typename T>
struct K16 {
    static constexpr int D = sizeof(T) == 4 ? 2 : 1;  // levels of prefetch
    static constexpr int RU = 4 + D;                   // slots of U and of V
    static constexpr int RW = 3 + D;                   // slots of WC
    static constexpr int RD = 1 + D;                   // slots of WD
    static constexpr int RR = 8;                       // staged rows
    static constexpr int IR = K16_TJ + 3;              // interpolant rows -1..TJ+1
    static constexpr int IC = km::TI + 4;              // columns -1..TI+1, padded
    static constexpr int PLANES = 2 * RU + RW + RD;
    static constexpr int SIZE = km::Slot<K16_TJ>::SIZE;
    static constexpr size_t smem =
        ((size_t)PLANES * SIZE + NI * IR * IC + RR * km::NCP) * sizeof(T);
};

// 7-point horizontal second derivative at a slot position P (q0 its value)
template <typename T>
__device__ __forceinline__ T lap_p(const T* P, T q0, T dxidxi, T dyidyi) {
    const T c0 = T(-1460. / 576.), c1 = T(783. / 576.), c2 = T(-54. / 576.),
            c3 = T(1. / 576.);
    constexpr int R = km::RS;
    return (c3 * (P[-3] + P[3]) + c2 * (P[-2] + P[2]) + c1 * (P[-1] + P[1])
            + c0 * q0) * dxidxi
           + (c3 * (P[-3 * R] + P[3 * R]) + c2 * (P[-2 * R] + P[2 * R])
              + c1 * (P[-R] + P[R]) + c0 * q0) * dyidyi;
}

// interpolation to i-1/2 (ixh) and j-1/2 (jyh) at a slot position P
template <typename T>
__device__ __forceinline__ T ixh_p(const T* P) {
    return interp4(P[-2], P[-1], P[0], P[1]);
}

template <typename T>
__device__ __forceinline__ T jyh_p(const T* P) {
    constexpr int R = km::RS;
    return interp4(P[-2 * R], P[-R], P[0], P[R]);
}

// The vertical ladders on the register column q (planes k-3..k+3) with the
// staged rows: row(e) holds the six taps for e = 0..3 (cell family: half
// level k-1+e; w family: centre k-2+e, clamped at the wall); vel = nullptr
// gives the gradient form, SQ squares the interpolant.  Taps outside the
// column have zero weight by construction and are skipped.
template <bool SQ, typename T, typename FR>
__device__ __forceinline__ T vd_rows(FR row, const T* q, const T* vel) {
    T x[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
        T wt[6];
        km::load6(row(e), wt);
        T acc = T(0);
#pragma unroll
        for (int j = 0; j < 6; ++j) {
            const int qi = e - 1 + j;
            if (qi < 0 || qi > 6) continue;
            acc = acc + wt[j] * q[qi];
        }
        x[e] = vel ? vel[e] * acc : (SQ ? acc * acc : acc);
    }
    return grad4(x[0], x[1], x[2], x[3]);
}

// three blocks an SM in float32 (at most 85 registers: a few bytes spill,
// and the k-split then fills 396 slots; 5.15 against 6.29 ms at
// weakscaling with two blocks of 128 registers on an H100 at 700 W,
// PERF.md section 6), two in float64 (three spill ~400 bytes and run at
// half the speed)
template <typename T, bool M>
__global__ void __launch_bounds__(K16_NT, sizeof(T) == 4 ? 3 : 2)
o4_mom_kernel(const T* __restrict__ u, const T* __restrict__ v,
              const T* __restrict__ wc, const T* __restrict__ wd, T* tu, T* tv,
              T* tw, const T* __restrict__ cc, int itot, int jtot, int ktot,
              int ks, T dxi, T dyi, T visc, int chunks, int vec_ok) {
    using G = K16<T>;
    constexpr int D = G::D, RU = G::RU, RW = G::RW, RD = G::RD, RR = G::RR;
    constexpr int SZ = G::SIZE, IC = G::IC, IP = G::IR * G::IC;
    constexpr int R = km::RS;
    T* const sU = reinterpret_cast<T*>(o4_smem);
    T* const sV = sU + RU * SZ;
    T* const sC = sV + RU * SZ;
    T* const sD = sC + RW * SZ;
    T* const sI = sD + RD * SZ;             // interpolant planes
    T* const sR = sI + NI * IP;             // staged rows
    const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * km::TI + tx;
    const int i0 = blockIdx.x * km::TI, j0 = blockIdx.y * K16_TJ;
    const int i = i0 + tx, j = j0 + ty;
    const bool inside = i < itot && j < jtot;
    int k0, k1;
    km::chunk_bounds(blockIdx.z, chunks, ktot, k0, k1);
    const long long plane = (long long)itot * jtot;
    const km::PlaneLoader<T, K16_TJ, K16_NT> ld(
        tid, i0, j0, itot, jtot, vec_ok && i0 + km::TI <= itot);
    // the point, wrapped where the tile passes the plane's edge (only its
    // stores are guarded), in the plane, in a slot and in an interpolant plane
    const int iw = wrap(i, itot), jw = wrap(j, jtot);
    const long long o2 = (long long)jw * itot + iw;
    const int me = (ty + km::H) * R + tx + km::C0;
    const int mi = (ty + 1) * IC + tx + 1;
    const T dxidxi = dxi * dxi, dyidyi = dyi * dyi;

    auto slotU = [](int p) { return (p + 3 * RU) % RU; };
    auto slotR = [](int r) { return (r + RR) % RR; };
    // plane p of a field: the ghost levels p = -3..ktot+2 as they are (a
    // copy for a level past the chunk's end is never read)
    auto lev = [&](int p) {
        return (long long)(ks + min(p, ktot + 2)) * plane;
    };
    auto row_in = [&](int r) {
        km::issue_row(sR + slotR(r) * km::NCP, cc, clampi(r, 0, ktot + 2), NC,
                      tid);
    };
    // group p: U, V plane p+1, WC plane p+2, WD plane p, table row p+3
    auto issue = [&](int p) {
        ld.issue(sU + slotU(p + 1) * SZ, u + lev(p + 1));
        ld.issue(sV + slotU(p + 1) * SZ, v + lev(p + 1));
        ld.issue(sC + ((p + 2) % RW) * SZ, wc + lev(p + 2));
        ld.issue(sD + (p % RD) * SZ, wd + lev(p));
        row_in(p + 3);
        km::commit();
    };

    // the register columns, planes k-3..k+3 at the point, and w interpolated
    // to the u and the v point at half levels k-1..k+2
    T Uw[7], Vw[7], Cw[7], Dw[7], IXWw[4], JYWw[4];
#pragma unroll
    for (int m = 0; m < 7; ++m) {
        const long long o = lev(k0 - 3 + m) + o2;
        Uw[m] = __ldg(u + o);
        Vw[m] = __ldg(v + o);
        Cw[m] = __ldg(wc + o);
        Dw[m] = __ldg(wd + o);
    }
    {
        long long oi[4], oj[4];
#pragma unroll
        for (int d = 0; d < 4; ++d) {
            oi[d] = (long long)jw * itot + wrap(i + d - 2, itot);
            oj[d] = (long long)wrap(j + d - 2, jtot) * itot + iw;
        }
#pragma unroll
        for (int e = 0; e < 3; ++e) {
            const T* a = wc + lev(k0 - 1 + e);
            IXWw[e] = interp4(__ldg(a + oi[0]), __ldg(a + oi[1]),
                              __ldg(a + oi[2]), __ldg(a + oi[3]));
            JYWw[e] = interp4(__ldg(a + oj[0]), __ldg(a + oj[1]),
                              __ldg(a + oj[2]), __ldg(a + oj[3]));
        }
        IXWw[3] = JYWw[3] = T(0);
    }

    // the planes and rows level k0 reads that no group p >= k0 brings
    for (int p = k0 - 2; p <= k0; ++p) {
        ld.issue(sU + slotU(p) * SZ, u + lev(p));
        ld.issue(sV + slotU(p) * SZ, v + lev(p));
    }
    ld.issue(sC + (k0 % RW) * SZ, wc + lev(k0));
    ld.issue(sC + ((k0 + 1) % RW) * SZ, wc + lev(k0 + 1));
    for (int r = k0 - 1; r <= k0 + 2; ++r) row_in(r);
#pragma unroll
    for (int p = 0; p < D; ++p) issue(k0 + p);

    for (int k = k0; k < k1; ++k) {
        km::wait_pending<D - 1>();
        __syncthreads();
        issue(k + D);
        // the column values of plane k+4, on their way during this level
        const long long on = lev(k + 4) + o2;
        const T nU = __ldg(u + on), nV = __ldg(v + on), nC = __ldg(wc + on),
                nD = __ldg(wd + on);
        const T* Uk = sU + slotU(k) * SZ;
        const T* Vk = sV + slotU(k) * SZ;
        const T* Ck = sC + (k % RW) * SZ;

        // ---- phase 1: the interpolants of the tile and its flux halo ----
        {
            const T* C2 = sC + ((k + 2) % RW) * SZ + me;
            IXWw[3] = ixh_p(C2);
            JYWw[3] = jyh_p(C2);
            T* I = sI + mi;
            I[IXU * IP] = ixh_p(Uk + me);
            I[JYU * IP] = jyh_p(Uk + me);
            I[IXV * IP] = ixh_p(Vk + me);
            I[JYV * IP] = jyh_p(Vk + me);
            I[IXW * IP] = IXWw[1];
            I[JYW * IP] = JYWw[1];
            I[UZ * IP] = interp4(Uw[1], Uw[2], Uw[3], Uw[4]);
            I[VZ * IP] = interp4(Vw[1], Vw[2], Vw[3], Vw[4]);
        }
        if (tid < 3 * km::TI + 3 * K16_TJ) {
            const T* Um2 = sU + slotU(k - 2) * SZ;
            const T* Um1 = sU + slotU(k - 1) * SZ;
            const T* Up1 = sU + slotU(k + 1) * SZ;
            int r, c;
            bool jh = tid < 3 * km::TI;
            if (jh) {
                // rows -1, TJ, TJ+1 of the tile's columns
                const int q = tid / km::TI;
                r = q == 0 ? -1 : K16_TJ - 1 + q;
                c = tid - q * km::TI;
            } else {
                // columns -1, TI, TI+1 of the tile's rows
                const int e = tid - 3 * km::TI, q = e / 3;
                r = q;
                c = e - 3 * q == 0 ? -1 : km::TI - 1 + (e - 3 * q);
            }
            const int at = (r + km::H) * R + c + km::C0;
            T* I = sI + (r + 1) * IC + c + 1;
            I[IXV * IP] = ixh_p(Vk + at);
            I[JYU * IP] = jyh_p(Uk + at);
            if (jh) {
                const T* Vm2 = sV + slotU(k - 2) * SZ;
                const T* Vm1 = sV + slotU(k - 1) * SZ;
                const T* Vp1 = sV + slotU(k + 1) * SZ;
                I[JYV * IP] = jyh_p(Vk + at);
                I[JYW * IP] = jyh_p(Ck + at);
                I[VZ * IP] = interp4(Vm2[at], Vm1[at], Vk[at], Vp1[at]);
            } else {
                I[IXU * IP] = ixh_p(Uk + at);
                I[IXW * IP] = ixh_p(Ck + at);
                I[UZ * IP] = interp4(Um2[at], Um1[at], Uk[at], Up1[at]);
            }
        }
        __syncthreads();

        // ---- phase 2: the three tendencies at the point ----
        const T* I = sI + mi;
        auto row = [&](int r) { return sR + slotR(r) * km::NCP; };
        const T dzi4 = row(k)[DZI4], dzhi4 = row(k)[DZHI4];
        const long long o = lev(k) + o2;
        // u
        {
            T t;
            if (!M) {
                t = -grad4(I[IXU * IP - 1] * I[IXU * IP - 1],
                           I[IXU * IP] * I[IXU * IP],
                           I[IXU * IP + 1] * I[IXU * IP + 1],
                           I[IXU * IP + 2] * I[IXU * IP + 2]) * dxi;
                t = t - grad4(I[IXV * IP - IC] * I[JYU * IP - IC],
                              I[IXV * IP] * I[JYU * IP],
                              I[IXV * IP + IC] * I[JYU * IP + IC],
                              I[IXV * IP + 2 * IC] * I[JYU * IP + 2 * IC]) * dyi;
                t = t - vd_rows<false, T>([&](int e) { return row(k + e) + TXA; },
                                          Uw, IXWw) * dzi4;
            } else {
                const T* P = Uk + me;
                t = flux4<T>([&](int d) { return I[IXU * IP + d]; },
                             [&](int d) { return d ? P[d] : Uw[3]; }) * dxi;
                t = t + flux4<T>([&](int d) { return I[IXV * IP + d * IC]; },
                                 [&](int d) { return d ? P[d * R] : Uw[3]; }) * dyi;
                t = t + vert4m_cell(k, ktot, Uw, IXWw) * dzi4;
            }
            t = t + visc * (lap_p(Uk + me, Uw[3], dxidxi, dyidyi)
                            + vd_rows<false, T>([&](int e) { return row(k + e) + TG; },
                                                Uw, nullptr) * dzi4);
            if (inside) tu[o] = tu[o] + t;
        }
        // v
        {
            T t;
            if (!M) {
                t = -grad4(I[JYU * IP - 1] * I[IXV * IP - 1],
                           I[JYU * IP] * I[IXV * IP],
                           I[JYU * IP + 1] * I[IXV * IP + 1],
                           I[JYU * IP + 2] * I[IXV * IP + 2]) * dxi;
                t = t - grad4(I[JYV * IP - IC] * I[JYV * IP - IC],
                              I[JYV * IP] * I[JYV * IP],
                              I[JYV * IP + IC] * I[JYV * IP + IC],
                              I[JYV * IP + 2 * IC] * I[JYV * IP + 2 * IC]) * dyi;
                t = t - vd_rows<false, T>([&](int e) { return row(k + e) + TXA; },
                                          Vw, JYWw) * dzi4;
            } else {
                const T* P = Vk + me;
                t = flux4<T>([&](int d) { return I[JYU * IP + d]; },
                             [&](int d) { return d ? P[d] : Vw[3]; }) * dxi;
                t = t + flux4<T>([&](int d) { return I[JYV * IP + d * IC]; },
                                 [&](int d) { return d ? P[d * R] : Vw[3]; }) * dyi;
                t = t + vert4m_cell(k, ktot, Vw, JYWw) * dzi4;
            }
            t = t + visc * (lap_p(Vk + me, Vw[3], dxidxi, dyidyi)
                            + vd_rows<false, T>([&](int e) { return row(k + e) + TG; },
                                                Vw, nullptr) * dzi4);
            if (inside) tv[o] = tv[o] + t;
        }
        // w at half level k; k = 0 is the wall
        if (k > 0) {
            T t;
            if (!M) {
                t = -grad4(I[UZ * IP - 1] * I[IXW * IP - 1],
                           I[UZ * IP] * I[IXW * IP],
                           I[UZ * IP + 1] * I[IXW * IP + 1],
                           I[UZ * IP + 2] * I[IXW * IP + 2]) * dxi;
                t = t - grad4(I[VZ * IP - IC] * I[JYW * IP - IC],
                              I[VZ * IP] * I[JYW * IP],
                              I[VZ * IP + IC] * I[JYW * IP + IC],
                              I[VZ * IP + 2 * IC] * I[JYW * IP + 2 * IC]) * dyi;
                t = t - vd_rows<true, T>([&](int e) { return row(k - 1 + e) + TWC; },
                                         Cw, nullptr) * dzhi4;
            } else {
                const T* P = Ck + me;
                t = flux4<T>([&](int d) { return I[UZ * IP + d]; },
                             [&](int d) { return d ? P[d] : Cw[3]; }) * dxi;
                t = t + flux4<T>([&](int d) { return I[VZ * IP + d * IC]; },
                                 [&](int d) { return d ? P[d * R] : Cw[3]; }) * dyi;
                t = t + vert4m_w(Cw) * dzhi4;
            }
            t = t + visc * (lap_p(sD + (k % RD) * SZ + me, Dw[3], dxidxi, dyidyi)
                            + vd_rows<false, T>([&](int e) { return row(k - 1 + e) + TGW; },
                                                Dw, nullptr) * dzhi4);
            if (inside) tw[o] = tw[o] + t;
        }

#pragma unroll
        for (int m = 0; m < 6; ++m) {
            Uw[m] = Uw[m + 1];
            Vw[m] = Vw[m + 1];
            Cw[m] = Cw[m + 1];
            Dw[m] = Dw[m + 1];
        }
        Uw[6] = nU; Vw[6] = nV; Cw[6] = nC; Dw[6] = nD;
#pragma unroll
        for (int e = 0; e < 3; ++e) {
            IXWw[e] = IXWw[e + 1];
            JYWw[e] = JYWw[e + 1];
        }
    }
    // no copy may land after the block has left its shared memory
    km::wait_all();
}

// the scalars', their carries' pointers and their viscosities, by value
template <typename T>
struct Scalars {
    const T* a[MAXS];
    T* ta[MAXS];
    T svisc[MAXS];
};

template <typename T, bool M>
__global__ void __launch_bounds__(OI * OJ)
o4_scalars_kernel(const T* __restrict__ u, const T* __restrict__ v,
                  const T* __restrict__ wc, const Scalars<T> sc, int S,
                  const T* __restrict__ cc, int itot, int jtot, int ktot,
                  int ks, T dxi, T dyi) {
    // one ring per scalar
    T (*sh)[NR][WJ][WI] = reinterpret_cast<T (*)[NR][WJ][WI]>(o4_smem);
    const int i0 = blockIdx.x * OI, j0 = blockIdx.y * OJ;
    const int i = i0 + threadIdx.x, j = j0 + threadIdx.y;
    const bool inside = i < itot && j < jtot;
    const long long plane = (long long)itot * jtot;
    const T dxidxi = dxi * dxi, dyidyi = dyi * dyi;
    const long long o2 = (long long)j * itot + i;
    // offsets -1..2 of the point along i and j, periodic
    long long oi[4], oj[4];
#pragma unroll
    for (int d = 0; d < 4; ++d) {
        oi[d] = (long long)j * itot + wrap(i + d - 1, itot);
        oj[d] = (long long)wrap(j + d - 1, jtot) * itot + i;
    }

    auto load = [&](int p) {
        const int s = slot7(p);
        for (int n = 0; n < S; ++n)
            load_tile7(sh[n][s], sc.a[n], ks + p, j0, i0, jtot, itot);
    };

    for (int p = -3; p < 3; ++p) load(p);
    for (int k = 0; k < ktot; ++k) {
        load(k + 3);
        __syncthreads();
        if (inside) {
            int sl[NR];
#pragma unroll
            for (int n = 0; n < NR; ++n) sl[n] = slot7(k - 3 + n);
            const int s0 = sl[3];
            const T* row = cc + (long long)k * NC;
            const T dzi4 = row[DZI4];
            const long long lev = (long long)(ks + k) * plane;
            // u at i-1..i+2, v at j-1..j+2, w at the half levels k-1..k+2
            T ux[4], vy[4], wv[4];
#pragma unroll
            for (int d = 0; d < 4; ++d) {
                ux[d] = __ldg(u + lev + oi[d]);
                vy[d] = __ldg(v + lev + oj[d]);
                wv[d] = __ldg(wc + lev + (long long)(d - 1) * plane + o2);
            }
            for (int n = 0; n < S; ++n) {
                const View7<T> A = view7<T>(sh[n]);
                T q[NR];
#pragma unroll
                for (int m = 0; m < NR; ++m) q[m] = A(sl[m], 0, 0);
                T t;
                if (!M) {
                    t = -div4<T>([&](int d) {
                            return ux[d + 1] * ixh(A, s0, 0, d);
                        }) * dxi;
                    t = t - div4<T>([&](int d) {
                                return vy[d + 1] * jyh(A, s0, d, 0);
                            }) * dyi;
                    t = t - vd_cell(cc, k, TXA, q, wv) * dzi4;
                } else {
                    t = flux4<T>([&](int d) { return ux[d + 1]; },
                                 [&](int d) { return A(s0, 0, d); }) * dxi;
                    t = t + flux4<T>([&](int d) { return vy[d + 1]; },
                                     [&](int d) { return A(s0, d, 0); }) * dyi;
                    t = t + vert4m_cell(k, ktot, q, wv) * dzi4;
                }
                t = t + sc.svisc[n] * (lap_h(A, s0, dxidxi, dyidyi)
                                       + vd_cell<T>(cc, k, TG, q, nullptr) * dzi4);
                sc.ta[n][lev + o2] = sc.ta[n][lev + o2] + t;
            }
        }
        __syncthreads();
    }
}

template <typename K>
static int raise_smem(K kernel, size_t smem) {
    return (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, bool M>
int launch_mom(const T* u, const T* v, const T* wc, const T* wd, T* tu, T* tv,
               T* tw, const T* cc, int itot, int jtot, int ktot, int ks,
               double dxi, double dyi, double visc, int chunks,
               cudaStream_t stream) {
    const size_t smem = K16<T>::smem;
    if (int rc = raise_smem(o4_mom_kernel<T, M>, smem)) return rc;
    const bool vec = itot % (16 / (int)sizeof(T)) == 0 && km::aligned16(u)
                     && km::aligned16(v) && km::aligned16(wc)
                     && km::aligned16(wd);
    const dim3 block(km::TI, K16_TJ);
    const dim3 grid((itot + km::TI - 1) / km::TI, (jtot + K16_TJ - 1) / K16_TJ,
                    chunks);
    o4_mom_kernel<T, M><<<grid, block, smem, stream>>>(
        u, v, wc, wd, tu, tv, tw, cc, itot, jtot, ktot, ks, T(dxi), T(dyi),
        T(visc), chunks, (int)vec);
    return (int)cudaGetLastError();
}

template <typename T, bool M>
int launch_scalars(const T* u, const T* v, const T* wc, const Scalars<T>& sc,
                   int S, const T* cc, int itot, int jtot, int ktot, int ks,
                   double dxi, double dyi, cudaStream_t stream) {
    const size_t smem = (size_t)S * NR * WJ * WI * sizeof(T);
    if (int rc = raise_smem(o4_scalars_kernel<T, M>, smem)) return rc;
    const dim3 block(OI, OJ);
    const dim3 grid((itot + OI - 1) / OI, (jtot + OJ - 1) / OJ);
    o4_scalars_kernel<T, M><<<grid, block, smem, stream>>>(
        u, v, wc, sc, S, cc, itot, jtot, ktot, ks, T(dxi), T(dyi));
    return (int)cudaGetLastError();
}

// scheme: 0 = advec 4, 1 = advec 4m (ops/o4_fused.py SCHEME_ID).  The
// fields need three ghost levels (ks >= 3).
template <typename T>
int mom(const T* u, const T* v, const T* wc, const T* wd, T* tu, T* tv, T* tw,
        const T* cc, int itot, int jtot, int ktot, int ks, int scheme,
        double dxi, double dyi, double visc, int chunks, cudaStream_t stream) {
    if (ks < OH || scheme < 0 || scheme > 1 || chunks < 1 || chunks > ktot)
        return (int)cudaErrorInvalidValue;
    if (scheme == 0)
        return launch_mom<T, false>(u, v, wc, wd, tu, tv, tw, cc, itot, jtot,
                                    ktot, ks, dxi, dyi, visc, chunks, stream);
    return launch_mom<T, true>(u, v, wc, wd, tu, tv, tw, cc, itot, jtot, ktot,
                               ks, dxi, dyi, visc, chunks, stream);
}

template <typename T>
int mom_info(int scheme, int* out) {
    if (scheme == 0)
        return km::kernel_info(o4_mom_kernel<T, false>, K16_NT, K16<T>::smem,
                               out);
    if (scheme == 1)
        return km::kernel_info(o4_mom_kernel<T, true>, K16_NT, K16<T>::smem,
                               out);
    return (int)cudaErrorInvalidValue;
}

template <typename T>
int scalars(const T* u, const T* v, const T* wc, const void* const* a,
            void* const* ta, const double* sviscs, int S, const T* cc,
            int itot, int jtot, int ktot, int ks, int scheme, double dxi,
            double dyi, cudaStream_t stream) {
    if (S < 1 || S > MAXS || ks < OH || scheme < 0 || scheme > 1)
        return (int)cudaErrorInvalidValue;
    Scalars<T> sc;
    for (int n = 0; n < MAXS; ++n) {
        sc.a[n] = n < S ? (const T*)a[n] : nullptr;
        sc.ta[n] = n < S ? (T*)ta[n] : nullptr;
        sc.svisc[n] = n < S ? T(sviscs[n]) : T(0);
    }
    if (scheme == 0)
        return launch_scalars<T, false>(u, v, wc, sc, S, cc, itot, jtot, ktot,
                                        ks, dxi, dyi, stream);
    return launch_scalars<T, true>(u, v, wc, sc, S, cc, itot, jtot, ktot, ks,
                                   dxi, dyi, stream);
}

}  // namespace o4
}  // namespace mhh

#define MHH_O4(SUF, T)                                                        \
    extern "C" int mhh_o4_mom_##SUF(                                          \
        const void* u, const void* v, const void* wc, const void* wd,         \
        void* tu, void* tv, void* tw, const void* cc, int itot, int jtot,     \
        int ktot, int ks, int scheme, double dxi, double dyi, double visc,    \
        int chunks, void* stream) {                                           \
        return mhh::o4::mom<T>((const T*)u, (const T*)v, (const T*)wc,        \
                               (const T*)wd, (T*)tu, (T*)tv, (T*)tw,          \
                               (const T*)cc, itot, jtot, ktot, ks, scheme,    \
                               dxi, dyi, visc, chunks, (cudaStream_t)stream); \
    }                                                                         \
    extern "C" int mhh_o4_mom_info_##SUF(int scheme, int S, int* out) {       \
        (void)S;                                                              \
        return mhh::o4::mom_info<T>(scheme, out);                             \
    }                                                                         \
    extern "C" int mhh_o4_scalars_##SUF(                                      \
        const void* u, const void* v, const void* wc, const void* const* a,   \
        void* const* ta, const double* sviscs, int S, const void* cc,         \
        int itot, int jtot, int ktot, int ks, int scheme, double dxi,         \
        double dyi, void* stream) {                                           \
        return mhh::o4::scalars<T>((const T*)u, (const T*)v, (const T*)wc, a, \
                                   ta, sviscs, S, (const T*)cc, itot, jtot,   \
                                   ktot, ks, scheme, dxi, dyi,                \
                                   (cudaStream_t)stream);                     \
    }

MHH_O4(f32, float)
MHH_O4(f64, double)
