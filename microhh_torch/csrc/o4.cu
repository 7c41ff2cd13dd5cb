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
// A grid of jtot = 1 takes each kernel's 2-D form (o4_mom_2d_kernel,
// o4_scalars_2d_kernel: the same march with D3 false), which computes what
// the JAX package's op path computes there: no y terms, no diffusion of v.
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
// writes S, about 135 operations a scalar and point (90 in 4m) and 49 a
// point for the vertical weights, so the bytes bind too.
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
// K17's design (kmarch.cuh, as K13's): a block of 32 x K17_TJ threads
// marches one chunk of the levels of its tile.  Shared memory holds plane k
// of each scalar, of u and of v (the tile and a 3-cell periodic halo) side
// by side in one ring slot a level, copied by cp.async two levels ahead
// (the fields share the loader's offsets, the level's offset is carried
// from level to level), one barrier a level; each thread
// keeps its own column, planes k-3..k+3 of every scalar and w at half
// levels k-1..k+2, in registers, shifted by one a level.  The vertical
// advection and diffusion are seven weights on that column: a per-level
// table (ops/o4_fused.py build_k17_rows, staged with the planes) holds
// them per unit w at each of the four half levels, with the ladder's wall
// rows and, in 4m, the mirrored wall fluxes at the global levels 0 and
// ktot-1 folded in, so both schemes share one vertical body and a chunk's
// edges need no rule of their own; the weights are formed once a point and
// level for all the scalars.  The horizontal parts take the seven values
// of the point's x and y lines, which the 7-point Laplacian reads anyway:
// each face interpolant is then four register FMAs, so they are not staged
// as flux planes (which would cost a second barrier, two stores and eight
// loads a scalar and point, and a halo of faces).  The scalar count is a
// template parameter (at most K17_MAXS a launch; the wrapper splits the
// rest over launches).
#include "kmarch.cuh"

namespace mhh {
namespace o4 {

// table columns (ops/o4_fused.py)
enum { TXA = 0, TG = 6, TWC = 12, TGW = 18, DZI4 = 24, DZHI4 = 25, WMASK = 26,
       NC = 27 };

constexpr int OH = 3;   // ghost levels the fields need

extern __shared__ __align__(16) unsigned char o4_smem[];

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

// its x part alone, the form of a 2-D run (jtot = 1), which has no y
// derivative (diff_4.cxx diff_c<TF, dim3 = false>)
template <typename T>
__device__ __forceinline__ T lap_x(const T* P, T q0, T dxidxi) {
    const T c0 = T(-1460. / 576.), c1 = T(783. / 576.), c2 = T(-54. / 576.),
            c3 = T(1. / 576.);
    return (c3 * (P[-3] + P[3]) + c2 * (P[-2] + P[2]) + c1 * (P[-1] + P[1])
            + c0 * q0) * dxidxi;
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

// jyh in either form: in a 2-D run the four rows are the point's own, so
// it is the point's value taken four times, and no halo row is read
template <bool D3, typename T>
__device__ __forceinline__ T jyh_d(const T* P) {
    if constexpr (D3) return jyh_p(P);
    else return interp4(P[0], P[0], P[0], P[0]);
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

// K16's march.  D3 false is the form of a 2-D run (jtot = 1), the JAX
// op path's with dim3 false (advec_4.cxx, advec_4m.cxx, diff_4.cxx): no y
// flux and no y part of the Laplacian, no diffusion of v at all, and v
// still advected (its x flux and its vertical flux, with w interpolated in
// j as the point's own value); the rows -1, TJ and TJ+1 of the
// interpolant planes, the planes JYV, JYW and VZ and the j-neighbour loads
// of w are not made.  Every 2-D difference is under if constexpr, so the
// 3-D instances are the code they were.
template <typename T, bool M, bool D3>
__device__ __forceinline__ void o4_mom_march(
    const T* __restrict__ u, const T* __restrict__ v,
    const T* __restrict__ wc, const T* __restrict__ wd, T* tu, T* tv, T* tw,
    const T* __restrict__ cc, int itot, int jtot, int ktot, int ks, T dxi,
    T dyi, T visc, int chunks, int vec_ok) {
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
            if constexpr (D3)
                JYWw[e] = interp4(__ldg(a + oj[0]), __ldg(a + oj[1]),
                                  __ldg(a + oj[2]), __ldg(a + oj[3]));
            else
                JYWw[e] = interp4(Cw[2 + e], Cw[2 + e], Cw[2 + e], Cw[2 + e]);
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
            JYWw[3] = jyh_d<D3>(C2);
            T* I = sI + mi;
            I[IXU * IP] = ixh_p(Uk + me);
            I[JYU * IP] = jyh_d<D3>(Uk + me);
            I[IXV * IP] = ixh_p(Vk + me);
            if constexpr (D3) I[JYV * IP] = jyh_p(Vk + me);
            I[IXW * IP] = IXWw[1];
            if constexpr (D3) I[JYW * IP] = JYWw[1];
            I[UZ * IP] = interp4(Uw[1], Uw[2], Uw[3], Uw[4]);
            if constexpr (D3) I[VZ * IP] = interp4(Vw[1], Vw[2], Vw[3], Vw[4]);
        }
        // the flux halo: in 2-D only the columns -1, TI and TI+1
        if (D3 ? tid < 3 * km::TI + 3 * K16_TJ
               : tid >= 3 * km::TI && tid < 3 * km::TI + 3 * K16_TJ) {
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
            I[JYU * IP] = jyh_d<D3>(Uk + at);
            if (D3 && jh) {
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
                if constexpr (D3)
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
                if constexpr (D3)
                    t = t + flux4<T>([&](int d) { return I[IXV * IP + d * IC]; },
                                     [&](int d) { return d ? P[d * R] : Uw[3]; }) * dyi;
                t = t + vert4m_cell(k, ktot, Uw, IXWw) * dzi4;
            }
            T lap;
            if constexpr (D3) lap = lap_p(Uk + me, Uw[3], dxidxi, dyidyi);
            else lap = lap_x(Uk + me, Uw[3], dxidxi);
            t = t + visc * (lap
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
                if constexpr (D3)
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
                if constexpr (D3)
                    t = t + flux4<T>([&](int d) { return I[JYV * IP + d * IC]; },
                                     [&](int d) { return d ? P[d * R] : Vw[3]; }) * dyi;
                t = t + vert4m_cell(k, ktot, Vw, JYWw) * dzi4;
            }
            // a 2-D run does not diffuse v (diff_4.cxx exec)
            if constexpr (D3)
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
                if constexpr (D3)
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
                if constexpr (D3)
                    t = t + flux4<T>([&](int d) { return I[VZ * IP + d * IC]; },
                                     [&](int d) { return d ? P[d * R] : Cw[3]; }) * dyi;
                t = t + vert4m_w(Cw) * dzhi4;
            }
            T lap;
            if constexpr (D3)
                lap = lap_p(sD + (k % RD) * SZ + me, Dw[3], dxidxi, dyidyi);
            else
                lap = lap_x(sD + (k % RD) * SZ + me, Dw[3], dxidxi);
            t = t + visc * (lap
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
    o4_mom_march<T, M, true>(u, v, wc, wd, tu, tv, tw, cc, itot, jtot, ktot,
                             ks, dxi, dyi, visc, chunks, vec_ok);
}

// the 2-D form (jtot = 1), at the 3-D form's launch bounds
template <typename T, bool M>
__global__ void __launch_bounds__(K16_NT, sizeof(T) == 4 ? 3 : 2)
o4_mom_2d_kernel(const T* __restrict__ u, const T* __restrict__ v,
                 const T* __restrict__ wc, const T* __restrict__ wd, T* tu,
                 T* tv, T* tw, const T* __restrict__ cc, int itot, int jtot,
                 int ktot, int ks, T dxi, T dyi, T visc, int chunks,
                 int vec_ok) {
    o4_mom_march<T, M, false>(u, v, wc, wd, tu, tv, tw, cc, itot, jtot, ktot,
                              ks, dxi, dyi, visc, chunks, vec_ok);
}

// K17's k-march (kmarch.cuh): 32 x K17_TJ tiles, K17_R ring slots of each
// scalar's, u's and v's plane (plane k read across the plane, k+1 and k+2
// in flight), K17_RR staged rows of the per-level table (row k read, two in
// flight), at most K17_MAXS scalars a launch.  A staged row holds at
// K17_ZA + 8 e + m the vertical advection's weight on column value m
// (plane k-3+m) per unit w at half level k-1+e (e = 0..3), at K17_ZD + m
// the vertical diffusion's (dzi4 folded in, the viscosity not).
constexpr int K17_TJ = 8;
constexpr int K17_NT = km::TI * K17_TJ;
constexpr int K17_D = 2;
constexpr int K17_R = K17_D + 1;
constexpr int K17_RR = K17_D + 1;
static_assert(K17_D <= 3, "the copies reach plane ktot - 1 + K17_D");
constexpr int K17_MAXS = 4;
constexpr int K17_ZA = 0;
constexpr int K17_ZD = 32;
constexpr int K17_NCP = 40;

// the scalars', their carries' pointers and their viscosities, by value
template <typename T>
struct O4Scalars {
    const T* a[K17_MAXS];
    T* ta[K17_MAXS];
    T svisc[K17_MAXS];
};

// eight consecutive values of a staged row (p 16-byte aligned)
__device__ __forceinline__ void load8(const float* p, float (&w)[8]) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
    w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
}

__device__ __forceinline__ void load8(const double* p, double (&w)[8]) {
#pragma unroll
    for (int n = 0; n < 4; ++n) {
        const double2 a = reinterpret_cast<const double2*>(p)[n];
        w[2 * n] = a.x;
        w[2 * n + 1] = a.y;
    }
}

// 7-point horizontal second derivative from the point's x and y lines,
// which the advection has already taken into registers (x[3] = y[3] the
// point), where K16's lap_p reads its slot
template <typename T>
__device__ __forceinline__ T lap_xy(const T (&x)[7], const T (&y)[7],
                                    T dxidxi, T dyidyi) {
    const T c0 = T(-1460. / 576.), c1 = T(783. / 576.), c2 = T(-54. / 576.),
            c3 = T(1. / 576.);
    return (c3 * (x[0] + x[6]) + c2 * (x[1] + x[5]) + c1 * (x[2] + x[4])
            + c0 * x[3]) * dxidxi
           + (c3 * (y[0] + y[6]) + c2 * (y[1] + y[5]) + c1 * (y[2] + y[4])
              + c0 * y[3]) * dyidyi;
}

// its x part alone (a 2-D run)
template <typename T>
__device__ __forceinline__ T lap_1(const T (&x)[7], T dxidxi) {
    const T c0 = T(-1460. / 576.), c1 = T(783. / 576.), c2 = T(-54. / 576.),
            c3 = T(1. / 576.);
    return (c3 * (x[0] + x[6]) + c2 * (x[1] + x[5]) + c1 * (x[2] + x[4])
            + c0 * x[3]) * dxidxi;
}

// the advective flux divergence along one line (before the 1/dx factor):
// vel[d] the velocity at face d - 3/2 of the point (d = 0..3), q the line
template <bool M, typename T>
__device__ __forceinline__ T hadv(const T (&vel)[4], const T (&q)[7]) {
    if (M)
        return flux4<T>([&](int d) { return vel[d + 1]; },
                        [&](int d) { return q[d + 3]; });
    return -grad4(vel[0] * interp4(q[0], q[1], q[2], q[3]),
                  vel[1] * interp4(q[1], q[2], q[3], q[4]),
                  vel[2] * interp4(q[2], q[3], q[4], q[5]),
                  vel[3] * interp4(q[3], q[4], q[5], q[6]));
}

// K17's march.  D3 false is the form of a 2-D run (jtot = 1): no y flux
// and no y part of the Laplacian; v's plane is not copied and no y line is
// read.  The 2-D differences are under if constexpr, so the 3-D instances
// are the code they were.
template <typename T, bool M, int S, bool D3>
__device__ __forceinline__ void o4_scalars_march(
    const T* __restrict__ u, const T* __restrict__ v,
    const T* __restrict__ wc, const O4Scalars<T> sc,
    const T* __restrict__ cz, int itot, int jtot, int ktot, int ks, T dxi,
    T dyi, int chunks, int vec_ok) {
    constexpr int SZ = km::Slot<K17_TJ>::SIZE, R = km::RS, PL = (S + 2) * SZ;
    // ring slots [K17_R][S + 2]: the S scalars', u's and v's planes of a
    // level side by side; then the staged rows
    T* const ring = reinterpret_cast<T*>(o4_smem);
    T* const rows = ring + K17_R * PL;
    const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * km::TI + tx;
    const int i0 = blockIdx.x * km::TI, j0 = blockIdx.y * K17_TJ;
    const int i = i0 + tx, j = j0 + ty;
    const bool inside = i < itot && j < jtot;
    int k0, k1;
    km::chunk_bounds(blockIdx.z, chunks, ktot, k0, k1);
    const long long plane = (long long)itot * jtot;
    const km::PlaneLoader<T, K17_TJ, K17_NT> ld(
        tid, i0, j0, itot, jtot, vec_ok && i0 + km::TI <= itot);
    // the point (wrapped where the tile passes the plane's edge: only its
    // stores are guarded), in the plane and in a slot
    const int iw = wrap(i, itot), jw = wrap(j, jtot);
    const long long o2 = (long long)jw * itot + iw;
    const int me = (ty + km::H) * R + tx + km::C0;
    const T dxidxi = dxi * dxi, dyidyi = dyi * dyi;
    const unsigned ring_s = (unsigned)__cvta_generic_to_shared(ring);
    const unsigned rows_s = (unsigned)__cvta_generic_to_shared(rows + tid);

    // group p into slot sl: plane p of the scalars, u and v (l its offset;
    // p <= ktot - 1 + K17_D, a ghost level), the fields sharing the
    // loader's offsets, and table row p (a copy for a level past the
    // chunk's end is never read)
    auto issue = [&](int p, int sl, long long l) {
#pragma unroll
        for (int n = 0; n < ld.NOP; ++n) {
            if (ld.src[n] < 0) continue;
            const unsigned d =
                ring_s + (unsigned)(sl * PL + (ld.dst[n] & (km::VEC - 1)))
                             * (unsigned)sizeof(T);
            const long long g = l + ld.src[n];
            constexpr unsigned F = SZ * sizeof(T);
            if (ld.dst[n] & km::VEC) {
#pragma unroll
                for (int f = 0; f < S; ++f)
                    km::cp_async<16>(d + f * F, sc.a[f] + g);
                km::cp_async<16>(d + S * F, u + g);
                if constexpr (D3) km::cp_async<16>(d + (S + 1) * F, v + g);
            } else {
#pragma unroll
                for (int f = 0; f < S; ++f)
                    km::cp_async<sizeof(T)>(d + f * F, sc.a[f] + g);
                km::cp_async<sizeof(T)>(d + S * F, u + g);
                if constexpr (D3)
                    km::cp_async<sizeof(T)>(d + (S + 1) * F, v + g);
            }
        }
        if (tid < K17_NCP)
            km::cp_async<sizeof(T)>(
                rows_s + (unsigned)(sl * K17_NCP * sizeof(T)),
                cz + (long long)min(p, ktot - 1) * K17_NCP + tid);
        km::commit();
    };

    // the register columns: planes k-3..k+3 of each scalar (the ghost
    // levels as they are), w at the half levels k-1..k+2
    long long lk = (long long)(ks + k0) * plane;    // plane k's offset
    const long long ltop = (long long)(ks + ktot + 2) * plane;
    T q[S][7], wv[4];
#pragma unroll
    for (int n = 0; n < S; ++n)
#pragma unroll
        for (int m = 0; m < 7; ++m)
            q[n][m] = __ldg(sc.a[n] + lk + (m - 3) * plane + o2);
#pragma unroll
    for (int e = 0; e < 4; ++e) wv[e] = __ldg(wc + lk + (e - 1) * plane + o2);

    int sl = k0 % K17_R;                            // the slot of plane k
#pragma unroll
    for (int d = 0; d < K17_D; ++d)
        issue(k0 + d, (sl + d) % K17_R, lk + d * plane);
    for (int k = k0; k < k1; ++k) {
        km::wait_pending<K17_D - 1>();
        __syncthreads();
        // plane k + D into the slot plane k - 1 left
        issue(k + K17_D, sl == 0 ? K17_R - 1 : sl - 1, lk + K17_D * plane);
        // the column values of the next level, on their way during this one
        const long long ln = k + 4 <= ktot + 2 ? lk + 4 * plane : ltop;
        T qn[S];
#pragma unroll
        for (int n = 0; n < S; ++n) qn[n] = __ldg(sc.a[n] + ln + o2);
        const T wn = __ldg(wc + lk + 3 * plane + o2);

        // the vertical weights on the column, the same for every scalar
        const T* zr = rows + sl * K17_NCP;
        T cv[7], cd[8];
        {
            T za[8];
            load8(zr + K17_ZA, za);
#pragma unroll
            for (int m = 0; m < 7; ++m) cv[m] = wv[0] * za[m];
#pragma unroll
            for (int e = 1; e < 4; ++e) {
                load8(zr + K17_ZA + 8 * e, za);
#pragma unroll
                for (int m = 0; m < 7; ++m) cv[m] = cv[m] + wv[e] * za[m];
            }
            load8(zr + K17_ZD, cd);
        }
        // u at i-1..i+2 and v at j-1..j+2: the faces of the point's fluxes
        const T* Pk = ring + sl * PL + me;
        const T* U = Pk + S * SZ;
        const T ux[4] = {U[-1], U[0], U[1], U[2]};
        T vy[4];
        if constexpr (D3) {
            const T* V = Pk + (S + 1) * SZ;
            vy[0] = V[-R]; vy[1] = V[0]; vy[2] = V[R]; vy[3] = V[2 * R];
        }
        const long long o = lk + o2;
#pragma unroll
        for (int n = 0; n < S; ++n) {
            const T* P = Pk + n * SZ;
            T x[7], y[7];
#pragma unroll
            for (int d = -3; d <= 3; ++d) {
                x[d + 3] = d ? P[d] : q[n][3];
                if constexpr (D3) y[d + 3] = d ? P[d * R] : q[n][3];
            }
            T va = cv[0] * q[n][0], vd = cd[0] * q[n][0];
#pragma unroll
            for (int m = 1; m < 7; ++m) {
                va = va + cv[m] * q[n][m];
                vd = vd + cd[m] * q[n][m];
            }
            T t;
            if constexpr (D3)
                t = hadv<M>(ux, x) * dxi + hadv<M>(vy, y) * dyi + va
                    + sc.svisc[n] * (lap_xy(x, y, dxidxi, dyidyi) + vd);
            else
                t = hadv<M>(ux, x) * dxi + va
                    + sc.svisc[n] * (lap_1(x, dxidxi) + vd);
            if (inside) sc.ta[n][o] = sc.ta[n][o] + t;
        }

#pragma unroll
        for (int n = 0; n < S; ++n) {
#pragma unroll
            for (int m = 0; m < 6; ++m) q[n][m] = q[n][m + 1];
            q[n][6] = qn[n];
        }
#pragma unroll
        for (int e = 0; e < 3; ++e) wv[e] = wv[e + 1];
        wv[3] = wn;
        lk += plane;
        sl = sl == K17_R - 1 ? 0 : sl + 1;
    }
    // no copy may land after the block has left its shared memory
    km::wait_all();
}

// four blocks an SM in float32 with one scalar (at most 64 registers, no
// spill: 1.61 against 1.70 ms with three at weakscaling on an H100 at
// 700 W, PERF.md section 6), three with two, two in float64; fewer with
// more scalars, whose columns need the registers
template <typename T, bool M, int S>
__global__ void __launch_bounds__(
    K17_NT, sizeof(T) == 4 ? (S == 1 ? 4 : (S == 2 ? 3 : 2))
                           : (S <= 2 ? 2 : 1))
o4_scalars_kernel(const T* __restrict__ u, const T* __restrict__ v,
                  const T* __restrict__ wc, const O4Scalars<T> sc,
                  const T* __restrict__ cz, int itot, int jtot, int ktot,
                  int ks, T dxi, T dyi, int chunks, int vec_ok) {
    o4_scalars_march<T, M, S, true>(u, v, wc, sc, cz, itot, jtot, ktot, ks,
                                    dxi, dyi, chunks, vec_ok);
}

// the 2-D form (jtot = 1), at the 3-D form's launch bounds
template <typename T, bool M, int S>
__global__ void __launch_bounds__(
    K17_NT, sizeof(T) == 4 ? (S == 1 ? 4 : (S == 2 ? 3 : 2))
                           : (S <= 2 ? 2 : 1))
o4_scalars_2d_kernel(const T* __restrict__ u, const T* __restrict__ v,
                     const T* __restrict__ wc, const O4Scalars<T> sc,
                     const T* __restrict__ cz, int itot, int jtot, int ktot,
                     int ks, T dxi, T dyi, int chunks, int vec_ok) {
    o4_scalars_march<T, M, S, false>(u, v, wc, sc, cz, itot, jtot, ktot, ks,
                                     dxi, dyi, chunks, vec_ok);
}

// dynamic shared memory of one K17 launch (ops/kmarch.py repeats it)
template <typename T>
constexpr size_t k17_smem(int S) {
    return ((size_t)(S + 2) * K17_R * km::Slot<K17_TJ>::SIZE
            + K17_RR * K17_NCP) * sizeof(T);
}

template <typename K>
static int raise_smem(K kernel, size_t smem) {
    return (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// the form a grid takes: the 2-D one at jtot = 1 (its info entries take
// the scheme plus 2)
template <typename T, bool M>
constexpr auto mom_kernel(bool d3) {
    return d3 ? o4_mom_kernel<T, M> : o4_mom_2d_kernel<T, M>;
}

template <typename T, bool M, int S>
constexpr auto scalars_kernel(bool d3) {
    return d3 ? o4_scalars_kernel<T, M, S> : o4_scalars_2d_kernel<T, M, S>;
}

template <typename T, bool M>
int launch_mom(const T* u, const T* v, const T* wc, const T* wd, T* tu, T* tv,
               T* tw, const T* cc, int itot, int jtot, int ktot, int ks,
               double dxi, double dyi, double visc, int chunks,
               cudaStream_t stream) {
    const size_t smem = K16<T>::smem;
    const auto kernel = mom_kernel<T, M>(jtot > 1);
    if (int rc = raise_smem(kernel, smem)) return rc;
    const bool vec = itot % (16 / (int)sizeof(T)) == 0 && km::aligned16(u)
                     && km::aligned16(v) && km::aligned16(wc)
                     && km::aligned16(wd);
    const dim3 block(km::TI, K16_TJ);
    const dim3 grid((itot + km::TI - 1) / km::TI, (jtot + K16_TJ - 1) / K16_TJ,
                    chunks);
    kernel<<<grid, block, smem, stream>>>(
        u, v, wc, wd, tu, tv, tw, cc, itot, jtot, ktot, ks, T(dxi), T(dyi),
        T(visc), chunks, (int)vec);
    return (int)cudaGetLastError();
}

template <typename T, bool M, int S>
int launch_scalars_s(const T* u, const T* v, const T* wc,
                     const O4Scalars<T>& sc, const T* cz, int itot, int jtot,
                     int ktot, int ks, double dxi, double dyi, int chunks,
                     cudaStream_t stream) {
    const size_t smem = k17_smem<T>(S);
    const auto kernel = scalars_kernel<T, M, S>(jtot > 1);
    if (int rc = raise_smem(kernel, smem)) return rc;
    bool vec = itot % (16 / (int)sizeof(T)) == 0 && km::aligned16(u)
               && km::aligned16(v);
    for (int n = 0; n < S; ++n) vec = vec && km::aligned16(sc.a[n]);
    const dim3 block(km::TI, K17_TJ);
    const dim3 grid((itot + km::TI - 1) / km::TI, (jtot + K17_TJ - 1) / K17_TJ,
                    chunks);
    kernel<<<grid, block, smem, stream>>>(
        u, v, wc, sc, cz, itot, jtot, ktot, ks, T(dxi), T(dyi), chunks,
        (int)vec);
    return (int)cudaGetLastError();
}

template <typename T, bool M>
int launch_scalars(const T* u, const T* v, const T* wc,
                   const O4Scalars<T>& sc, int S, const T* cz, int itot,
                   int jtot, int ktot, int ks, double dxi, double dyi,
                   int chunks, cudaStream_t stream) {
    switch (S) {
    case 1:
        return launch_scalars_s<T, M, 1>(u, v, wc, sc, cz, itot, jtot, ktot,
                                         ks, dxi, dyi, chunks, stream);
    case 2:
        return launch_scalars_s<T, M, 2>(u, v, wc, sc, cz, itot, jtot, ktot,
                                         ks, dxi, dyi, chunks, stream);
    case 3:
        return launch_scalars_s<T, M, 3>(u, v, wc, sc, cz, itot, jtot, ktot,
                                         ks, dxi, dyi, chunks, stream);
    case 4:
        return launch_scalars_s<T, M, 4>(u, v, wc, sc, cz, itot, jtot, ktot,
                                         ks, dxi, dyi, chunks, stream);
    }
    return (int)cudaErrorInvalidValue;
}

template <typename T, bool M>
int info_scalars(int S, bool d3, int* out) {
    switch (S) {
    case 1:
        return km::kernel_info(scalars_kernel<T, M, 1>(d3), K17_NT,
                               k17_smem<T>(1), out);
    case 2:
        return km::kernel_info(scalars_kernel<T, M, 2>(d3), K17_NT,
                               k17_smem<T>(2), out);
    case 3:
        return km::kernel_info(scalars_kernel<T, M, 3>(d3), K17_NT,
                               k17_smem<T>(3), out);
    case 4:
        return km::kernel_info(scalars_kernel<T, M, 4>(d3), K17_NT,
                               k17_smem<T>(4), out);
    }
    return (int)cudaErrorInvalidValue;
}

// scheme: 0 = advec 4, 1 = advec 4m (ops/o4_fused.py SCHEME_ID).  The
// fields need three ghost levels (ks >= 3).  A grid of jtot = 1 takes the
// 2-D form.
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

// scheme: 0 or 1 the 3-D form, 2 or 3 the 2-D form of scheme - 2
template <typename T>
int mom_info(int scheme, int* out) {
    if (scheme < 0 || scheme > 3) return (int)cudaErrorInvalidValue;
    const bool d3 = scheme < 2;
    if (scheme % 2 == 0)
        return km::kernel_info(mom_kernel<T, false>(d3), K16_NT, K16<T>::smem,
                               out);
    return km::kernel_info(mom_kernel<T, true>(d3), K16_NT, K16<T>::smem, out);
}

template <typename T>
int scalars(const T* u, const T* v, const T* wc, const void* const* a,
            void* const* ta, const double* sviscs, int S, const T* cz,
            int itot, int jtot, int ktot, int ks, int scheme, double dxi,
            double dyi, int chunks, cudaStream_t stream) {
    if (S < 1 || S > K17_MAXS || ks < OH || scheme < 0 || scheme > 1
        || chunks < 1 || chunks > ktot)
        return (int)cudaErrorInvalidValue;
    O4Scalars<T> sc;
    for (int n = 0; n < K17_MAXS; ++n) {
        sc.a[n] = n < S ? (const T*)a[n] : nullptr;
        sc.ta[n] = n < S ? (T*)ta[n] : nullptr;
        sc.svisc[n] = n < S ? T(sviscs[n]) : T(0);
    }
    if (scheme == 0)
        return launch_scalars<T, false>(u, v, wc, sc, S, cz, itot, jtot, ktot,
                                        ks, dxi, dyi, chunks, stream);
    return launch_scalars<T, true>(u, v, wc, sc, S, cz, itot, jtot, ktot, ks,
                                   dxi, dyi, chunks, stream);
}

template <typename T>
int scalars_info(int scheme, int S, int* out) {
    if (scheme < 0 || scheme > 3) return (int)cudaErrorInvalidValue;
    if (scheme % 2 == 0) return info_scalars<T, false>(S, scheme < 2, out);
    return info_scalars<T, true>(S, scheme < 2, out);
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
        void* const* ta, const double* sviscs, int S, const void* cz,         \
        int itot, int jtot, int ktot, int ks, int scheme, double dxi,         \
        double dyi, int chunks, void* stream) {                               \
        return mhh::o4::scalars<T>((const T*)u, (const T*)v, (const T*)wc, a, \
                                   ta, sviscs, S, (const T*)cz, itot, jtot,   \
                                   ktot, ks, scheme, dxi, dyi, chunks,        \
                                   (cudaStream_t)stream);                     \
    }                                                                         \
    extern "C" int mhh_o4_scalars_info_##SUF(int scheme, int S, int* out) {   \
        return mhh::o4::scalars_info<T>(scheme, S, out);                      \
    }

MHH_O4(f32, float)
MHH_O4(f64, double)
