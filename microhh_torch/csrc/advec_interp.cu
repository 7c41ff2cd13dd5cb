// K12 and K13: the interpolated advection schemes 2i4 / 2i5 / 2i53 / 2i62
// (advec_2i4.cxx, advec_2i5.cxx, advec_2i53.cxx, advec_2i62.cxx) added into
// the RK carry in one pass per field group.
//
// K12 advec_mom: tu, tv, tw += advection of u, v, w.  Replaces the momentum
// call of AdvecInterpPallas._core (microhh_tpu/ops/advec_interp_pallas.py
// :362, pallas_call :379; body _mom_body :248).
// K13 advec_scalars: each of S scalars' carry += its advection, with u, v, w
// read once for all of them.  Replaces the scalar call (:403; body
// _scalar_body :294).
//
// Horizontal: the advecting velocity is interpolated 2nd-order to the flux
// face, the transported quantity by a 6-tap centred (4-tap for 2i4) value
// plus, for 2i5 and 2i53, a 5-tap upwind part weighted with |velocity|;
// taps reach i +- 3 and j +- 3, periodic.  Vertical: row k of the table cc
// (ops/advec_interp_fused.py build_interp_tables) holds six density-
// prescaled tap weights per face and centre, applied to planes k-3..k+3
// whose index is CLAMPED to the interior ([ks, ke-1] for u, v and the
// scalars, [ks, ke] for w): the zero weights near a wall, not the ghost
// planes, make the wall fluxes right, so one body serves every rung of the
// ladder and the four schemes differ only in the table and in two
// compile-time flags (C4: 4th-order centred horizontal; UP: upwind parts).
//
// Bound: device-memory bytes.  K12 reads u, v, w and reads and writes the
// three carries: 9 x 4 B per point in f32 (2.05 GB at 384^3), ~400 flops
// per point.  K13 with S scalars reads 3 + 2S fields and writes S: 15 x 4 B
// for S = 4 (3.41 GB).  Both march chunks of k on kmarch.cuh: a block of
// 32 x TJ threads owns one tile of the plane and marches one chunk of its
// levels, the chunk count chosen by the wrapper (ops/kmarch.py plan) so
// that the grid fills the card in whole waves.  Only the planes read
// across the plane sit in shared memory, copied by cp.async two levels
// ahead with one barrier a level; each thread keeps its own column, planes
// k-3..k+3 of each transported field, in registers and shifts it by one a
// level, the new value loaded one level ahead; the table rows come into
// shared memory with the planes.  The carries are updated in place, each
// point and level by one block.
// K13's design: shared memory holds plane k of each scalar in three slots
// (k+1 and k+2 in flight); u, v at the point and its +1 neighbours and w at
// the faces k and k+1 come as register values loaded one level ahead; the
// vertical part's seven weights on the column are formed once a point and
// level for all the scalars.  The scalar count is a template parameter (at
// most MAXA a launch; the wrapper splits the rest over launches).
// K12's design: group p of the march is plane p of u and v and plane p + 1
// of w, side by side in one ring slot and sharing the loader's offsets; at
// level k the block reads group k (u, v at k: the u and v families'
// stencils; w at k + 1: the faces k + 1 of u and v) and group k - 1 (w at
// k: the w family's stencils; u at k - 1, i + 1 and v at k - 1, j + 1: w's
// advecting velocities), so the ring holds four slots (two read, one in
// flight, one being filled).  Each chunk issues group k0 - 1 first, so
// its first level needs no rule of its own.  (Three slots with w's k + 1
// neighbours loaded one level ahead and u, v at k - 1 carried in
// registers read 1.60 against 1.41 ms at rico 384^3 in float32.)  The columns of u, v and w are
// clamped as the table expects ([ks, ke-1] for u and v, [ks, ke] for w),
// at the warm-up and at the prefetch alike; face k's interpolated w of u
// and of v is carried from the level below (at the chunk's first level
// read from device memory).  The vertical parts are the six-tap ladders
// of the staged rows k - 1, k and k + 1 (a ring of K12_RR, row k0 - 1 staged
// with the chunk's first group) on the register columns.
#include "kmarch.cuh"

namespace mhh {

// table columns (ops/advec_interp_fused.py)
enum { WXF = 0, WUF = 6, WXC = 12, WUC = 18, RCDZI = 24, RHDZHI = 25,
       WMASK = 26, NC = 27 };

constexpr int MAXA = 4;   // scalars a K13 launch

extern __shared__ __align__(16) unsigned char adv_smem[];

// Flux divergence along one axis (before the 1/dx factor): q(d) is the
// transported quantity at offset d along the axis, vR and vL the advecting
// velocities at the right and the left face of the point.
template <bool C4, bool UP, typename T, typename F>
__device__ __forceinline__ T hdiv(F q, T vR, T vL) {
    const T qm3 = q(-3), qm2 = q(-2), qm1 = q(-1), q0 = q(0), qp1 = q(1),
            qp2 = q(2), qp3 = q(3);
    T cR, cL;
    if (C4) {
        const T ci0 = T(-1. / 16.), ci1 = T(9. / 16.);
        cR = ci0 * qm1 + ci1 * q0 + ci1 * qp1 + ci0 * qp2;
        cL = ci0 * qm2 + ci1 * qm1 + ci1 * q0 + ci0 * qp1;
    } else {
        const T a = T(37. / 60.), b = T(8. / 60.), c = T(1. / 60.);
        cR = a * (q0 + qp1) - b * (qm1 + qp2) + c * (qm2 + qp3);
        cL = a * (qm1 + q0) - b * (qm2 + qp1) + c * (qm3 + qp2);
    }
    T out = -(vR * cR - vL * cL);
    if (UP) {
        const T a = T(10. / 60.), b = T(5. / 60.), c = T(1. / 60.);
        const T uR = a * (qp1 - q0) - b * (qp2 - qm1) + c * (qp3 - qm2);
        const T uL = a * (q0 - qm1) - b * (qp1 - qm2) + c * (qp2 - qm3);
        out = out + (fabs(vR) * uR - fabs(vL) * uL);
    }
    return out;
}

// K12's k-march (kmarch.cuh): 32 x K12_TJ tiles, K12_R ring slots of a
// group (u's and v's plane p and w's plane p + 1 side by side), K12_RR
// staged table rows (k - 1, k and k + 1 read, k + 2 and k + 3 in flight).
constexpr int K12_TJ = 8;
constexpr int K12_NT = km::TI * K12_TJ;
constexpr int K12_R = 4;
constexpr int K12_RR = 8;
static_assert((K12_R & (K12_R - 1)) == 0 && (K12_RR & (K12_RR - 1)) == 0,
              "slots are taken modulo a power of two");

// the six-tap ladder of a staged row's columns C..C+5 on q[O..O+5]
template <int C, int O, typename T>
__device__ __forceinline__ T ladder(const T* row, const T (&q)[7]) {
    T x[6];
    km::load6(row + C, x);
    T acc = x[0] * q[O];
#pragma unroll
    for (int m = 1; m < 6; ++m) acc = acc + x[m] * q[O + m];
    return acc;
}

// The vertical flux divergence (before its factor) of a column q (planes
// k-3..k+3) between its lower face (row r0 on planes k-3..k+2, advecting
// velocity w0) and its upper face (row r1 on planes k-2..k+3, w1); X and
// UC: the columns of the centred and the upwind ladder.
template <int X, int UC, bool UP, typename T>
__device__ __forceinline__ T vdiv(const T* r0, const T* r1, const T (&q)[7],
                                  T w0, T w1) {
    T out = w0 * ladder<X, 0>(r0, q) - w1 * ladder<X, 1>(r1, q);
    if (UP)
        out = out + (fabs(w1) * ladder<UC, 1>(r1, q)
                     - fabs(w0) * ladder<UC, 0>(r0, q));
    return out;
}

// three blocks an SM in float32 (at most 85 registers; four, at most 64
// and a spill, read 1.77 against 1.67 ms at jaenschwalde on an H100 at
// 700 W, PERF.md section 6), two in float64
template <typename T, bool C4, bool UP>
__global__ void __launch_bounds__(K12_NT, sizeof(T) == 4 ? 3 : 2)
advec_mom_kernel(const T* __restrict__ u, const T* __restrict__ v,
                 const T* __restrict__ w, T* tu, T* tv, T* tw,
                 const T* __restrict__ cc, int itot, int jtot, int ktot,
                 int ks, T dxi, T dyi, int chunks, int vec_ok) {
    constexpr int SZ = km::Slot<K12_TJ>::SIZE, R = km::RS, PL = 3 * SZ;
    // ring slots [K12_R] of (u, v, w) planes, then the staged rows
    T* const ring = reinterpret_cast<T*>(adv_smem);
    T* const rows = ring + K12_R * PL;
    const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * km::TI + tx;
    const int i0 = blockIdx.x * km::TI, j0 = blockIdx.y * K12_TJ;
    const int i = i0 + tx, j = j0 + ty;
    const bool inside = i < itot && j < jtot;
    int k0, k1;
    km::chunk_bounds(blockIdx.z, chunks, ktot, k0, k1);
    const int ke = ks + ktot;
    const long long plane = (long long)itot * jtot;
    const km::PlaneLoader<T, K12_TJ, K12_NT> ld(
        tid, i0, j0, itot, jtot, vec_ok && i0 + km::TI <= itot);
    // the point (wrapped where the tile passes the plane's edge: only its
    // stores are guarded), in the plane and in a slot
    const int iw = wrap(i, itot), jw = wrap(j, jtot);
    const long long o2 = (long long)jw * itot + iw;
    const int me = (ty + km::H) * R + tx + km::C0;
    const unsigned ring_s = (unsigned)__cvta_generic_to_shared(ring);
    const unsigned rows_s = (unsigned)__cvta_generic_to_shared(rows + tid);
    const T half = T(0.5);

    // the planes of u and v (clamped to [ks, ke-1]) and of w ([ks, ke])
    auto lev_uv = [&](int p) {
        return (long long)clampi(ks + p, ks, ke - 1) * plane;
    };
    auto lev_w = [&](int p) {
        return (long long)clampi(ks + p, ks, ke) * plane;
    };
    // table row r (clamped to [0, ktot]) into staged slot r
    auto row_in = [&](int r) {
        if (tid < NC)
            km::cp_async<sizeof(T)>(
                rows_s + (unsigned)((r & (K12_RR - 1)) * km::NCP * sizeof(T)),
                cc + (long long)clampi(r, 0, ktot) * NC + tid);
    };
    // group p into slot sl: plane p of u and v, plane p + 1 of w (their
    // first values formed once a group, the loader's offsets shared by the
    // three), and table row p + 1 (a copy for a level past the chunk's end
    // is never read)
    auto issue = [&](int p, int sl) {
        const long long luv = lev_uv(p);
        const T* const ug = u + luv;
        const T* const vg = v + luv;
        const T* const wg = w + lev_w(p + 1);
        const unsigned s0 = ring_s + (unsigned)(sl * PL * sizeof(T));
        constexpr unsigned F = SZ * sizeof(T);
#pragma unroll
        for (int n = 0; n < ld.NOP; ++n) {
            if (ld.src[n] < 0) continue;
            const unsigned d =
                s0 + (unsigned)((ld.dst[n] & (km::VEC - 1)) * sizeof(T));
            const int o = ld.src[n];
            if (ld.dst[n] & km::VEC) {
                km::cp_async<16>(d, ug + o);
                km::cp_async<16>(d + F, vg + o);
                km::cp_async<16>(d + 2 * F, wg + o);
            } else {
                km::cp_async<sizeof(T)>(d, ug + o);
                km::cp_async<sizeof(T)>(d + F, vg + o);
                km::cp_async<sizeof(T)>(d + 2 * F, wg + o);
            }
        }
        row_in(p + 1);
        km::commit();
    };

    // the register columns: planes k-3..k+3 of u, v and w (clamped)
    T uq[7], vq[7], wq[7];
#pragma unroll
    for (int m = 0; m < 7; ++m) {
        const long long luv = lev_uv(k0 - 3 + m) + o2;
        uq[m] = __ldg(u + luv);
        vq[m] = __ldg(v + luv);
        wq[m] = __ldg(w + lev_w(k0 - 3 + m) + o2);
    }
    // w interpolated to face k of u (i - 1/2) and of v (j - 1/2), carried
    // from level to level
    T wfu, wfv;
    {
        const T* wk = w + (long long)(ks + k0) * plane;
        wfu = half * (__ldg(wk + (long long)jw * itot + wrap(i - 1, itot))
                      + wq[3]);
        wfv = half * (__ldg(wk + (long long)wrap(j - 1, jtot) * itot + iw)
                      + wq[3]);
    }

    // group p lives in slot (p - k0 + 1) mod K12_R; row k0 - 1 is read at
    // the chunk's first level (w's lower centre)
    row_in(k0 - 1);
    issue(k0 - 1, 0);
    issue(k0, 1);
    issue(k0 + 1, 2);
    for (int k = k0; k < k1; ++k) {
        km::wait_pending<1>();
        __syncthreads();
        const int z = k - k0;
        // group k + 2 into the slot group k - 2 left
        issue(k + 2, (z + 3) & (K12_R - 1));
        // the column values of the next level, on their way during this one
        const long long ln = lev_uv(k + 4) + o2;
        const T un = __ldg(u + ln), vn = __ldg(v + ln),
                wn = __ldg(w + lev_w(k + 4) + o2);

        // group k: u, v at k, w at k + 1; group k - 1: u, v at k - 1, w at k
        const T* const U = ring + ((z + 1) & (K12_R - 1)) * PL + me;
        const T* const V = U + SZ;
        const T* const W1 = U + 2 * SZ;
        const T* const Um = ring + (z & (K12_R - 1)) * PL + me;
        const T* const Vm = Um + SZ;
        const T* const W = Um + 2 * SZ;
        const T* const rm = rows + ((k - 1) & (K12_RR - 1)) * km::NCP;
        const T* const r0 = rows + (k & (K12_RR - 1)) * km::NCP;
        const T* const r1 = rows + ((k + 1) & (K12_RR - 1)) * km::NCP;
        const long long o = (long long)(ks + k) * plane + o2;

        // w at face k + 1 of u and of v: the next level's face k
        const T wfu1 = half * (W1[-1] + wq[4]);
        const T wfv1 = half * (W1[-R] + wq[4]);
        const T fz = r0[RCDZI];
        // ---- u ----
        {
            T t = hdiv<C4, UP, T>([&](int d) { return d ? U[d] : uq[3]; },
                                  half * (uq[3] + U[1]),
                                  half * (U[-1] + uq[3])) * dxi;
            t = t + hdiv<C4, UP, T>([&](int d) { return d ? U[d * R] : uq[3]; },
                                    half * (V[R - 1] + V[R]),
                                    half * (V[-1] + vq[3])) * dyi;
            t = t + vdiv<WXF, WUF, UP>(r0, r1, uq, wfu, wfu1) * fz;
            if (inside) tu[o] = tu[o] + t;
        }
        // ---- v ----
        {
            T t = hdiv<C4, UP, T>([&](int d) { return d ? V[d] : vq[3]; },
                                  half * (U[1 - R] + U[1]),
                                  half * (U[-R] + uq[3])) * dxi;
            t = t + hdiv<C4, UP, T>([&](int d) { return d ? V[d * R] : vq[3]; },
                                    half * (vq[3] + V[R]),
                                    half * (V[-R] + vq[3])) * dyi;
            t = t + vdiv<WXF, WUF, UP>(r0, r1, vq, wfv, wfv1) * fz;
            if (inside) tv[o] = tv[o] + t;
        }
        // ---- w at half level k; the global level 0 is the wall ----
        if (k > 0) {
            T t = hdiv<C4, UP, T>([&](int d) { return d ? W[d] : wq[3]; },
                                  half * (Um[1] + U[1]),
                                  half * (uq[2] + uq[3])) * dxi;
            t = t + hdiv<C4, UP, T>([&](int d) { return d ? W[d * R] : wq[3]; },
                                    half * (Vm[R] + V[R]),
                                    half * (vq[2] + vq[3])) * dyi;
            // the centres k - 1 (row k - 1) and k (row k)
            t = t + vdiv<WXC, WUC, UP>(rm, r0, wq, half * (wq[2] + wq[3]),
                                       half * (wq[3] + wq[4])) * r0[RHDZHI];
            if (inside) tw[o] = tw[o] + t;
        }

#pragma unroll
        for (int m = 0; m < 6; ++m) {
            uq[m] = uq[m + 1];
            vq[m] = vq[m + 1];
            wq[m] = wq[m + 1];
        }
        uq[6] = un; vq[6] = vn; wq[6] = wn;
        wfu = wfu1; wfv = wfv1;
    }
    // no copy may land after the block has left its shared memory
    km::wait_all();
}

// dynamic shared memory of one K12 launch (ops/kmarch.py repeats it)
template <typename T>
constexpr size_t k12_smem() {
    return ((size_t)K12_R * 3 * km::Slot<K12_TJ>::SIZE + K12_RR * km::NCP)
           * sizeof(T);
}

// the scalars' and their carries' pointers, passed by value
template <typename T>
struct AdvScalars {
    const T* a[MAXA];
    T* ta[MAXA];
};

// K13's k-march (kmarch.cuh): 32 x K13_TJ tiles, K13_R ring slots a scalar
// (plane k read across the plane, k+1 and k+2 in flight), K13_RR staged
// table rows (k and k+1 read, two in flight), at most MAXA scalars a
// launch, each with its own column of seven values in registers.
constexpr int K13_TJ = 8;
constexpr int K13_NT = km::TI * K13_TJ;
constexpr int K13_R = 3;
constexpr int K13_RR = 4;

// The vertical flux divergence at level k as seven weights on the column
// q[0..6] (planes k-3..k+3), the same for every scalar at the point:
// sum_m c[m] q[m] = (w0 X0 - w1 X1 - |w0| U0 + |w1| U1) rcdzi with X0, U0
// the face-k ladders (row k, planes k-3..k+2) and X1, U1 the face-k+1
// ladders (row k+1, planes k-2..k+3).
template <bool UP, typename T>
__device__ __forceinline__ void vweights(const T* r0, const T* r1, T w0, T w1,
                                         T (&c)[7]) {
    T x0[6], x1[6];
    km::load6(r0 + WXF, x0);
    km::load6(r1 + WXF, x1);
    c[6] = T(0);
#pragma unroll
    for (int m = 0; m < 6; ++m) c[m] = w0 * x0[m];
#pragma unroll
    for (int m = 0; m < 6; ++m) c[m + 1] = c[m + 1] - w1 * x1[m];
    if (UP) {
        const T a0 = fabs(w0), a1 = fabs(w1);
        km::load6(r0 + WUF, x0);
        km::load6(r1 + WUF, x1);
#pragma unroll
        for (int m = 0; m < 6; ++m) c[m] = c[m] - a0 * x0[m];
#pragma unroll
        for (int m = 0; m < 6; ++m) c[m + 1] = c[m + 1] + a1 * x1[m];
    }
    const T f = r0[RCDZI];
#pragma unroll
    for (int m = 0; m < 7; ++m) c[m] = c[m] * f;
}

// three blocks an SM in float32, four with one or two scalars (at most 64
// registers: the columns of three or four scalars would spill); two in
// float64
template <typename T, bool C4, bool UP, int S>
__global__ void __launch_bounds__(K13_NT,
                                  sizeof(T) == 4 ? (S <= 2 ? 4 : 3) : 2)
advec_scalars_kernel(const T* __restrict__ u, const T* __restrict__ v,
                     const T* __restrict__ w, const AdvScalars<T> sc,
                     const T* __restrict__ cc, int itot, int jtot, int ktot,
                     int ks, T dxi, T dyi, int chunks, int vec_ok) {
    using Sl = km::Slot<K13_TJ>;
    // rings[n][slot] then the staged rows
    T* const ring = reinterpret_cast<T*>(adv_smem);
    T* const rows = ring + S * K13_R * Sl::SIZE;
    const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * km::TI + tx;
    const int i0 = blockIdx.x * km::TI, j0 = blockIdx.y * K13_TJ;
    const int i = i0 + tx, j = j0 + ty;
    const bool inside = i < itot && j < jtot;
    int k0, k1;
    km::chunk_bounds(blockIdx.z, chunks, ktot, k0, k1);
    const int ke = ks + ktot;
    const long long plane = (long long)itot * jtot;
    const km::PlaneLoader<T, K13_TJ, K13_NT> ld(
        tid, i0, j0, itot, jtot, vec_ok && i0 + km::TI <= itot);
    // the point (wrapped where the tile passes the plane's edge: only its
    // stores are guarded) and its +1 neighbours in the plane
    const int iw = wrap(i, itot), jw = wrap(j, jtot);
    const long long o2 = (long long)jw * itot + iw;
    const long long o2_ip = (long long)jw * itot + wrap(i + 1, itot);
    const long long o2_jp = (long long)wrap(j + 1, jtot) * itot + iw;
    const int me = (ty + km::H) * km::RS + tx + km::C0;

    // group p: plane p (clamped) of every scalar and table row p + 1
    auto issue = [&](int p) {
        const long long lev = (long long)clampi(ks + p, ks, ke - 1) * plane;
#pragma unroll
        for (int n = 0; n < S; ++n)
            ld.issue(ring + (n * K13_R + p % K13_R) * Sl::SIZE, sc.a[n] + lev);
        const int r = min(p + 1, ktot);
        km::issue_row(rows + ((p + 1) % K13_RR) * km::NCP, cc, r, NC, tid);
        km::commit();
    };

    // the register columns: planes k-3..k+3 (clamped) of each scalar
    T q[S][7];
#pragma unroll
    for (int n = 0; n < S; ++n)
#pragma unroll
        for (int m = 0; m < 7; ++m)
            q[n][m] = __ldg(sc.a[n] + (long long)clampi(ks + k0 - 3 + m, ks, ke - 1)
                                          * plane + o2);
    // u, v at the point and its +1 neighbour, w at the faces k and k+1
    auto level_of = [&](int k) { return (long long)(ks + k) * plane; };
    T uL = __ldg(u + level_of(k0) + o2), uR = __ldg(u + level_of(k0) + o2_ip);
    T vL = __ldg(v + level_of(k0) + o2), vR = __ldg(v + level_of(k0) + o2_jp);
    T w0 = __ldg(w + level_of(k0) + o2), w1 = __ldg(w + level_of(k0 + 1) + o2);

    km::issue_row(rows + (k0 % K13_RR) * km::NCP, cc, k0, NC, tid);
    issue(k0);
    issue(k0 + 1);
    for (int k = k0; k < k1; ++k) {
        km::wait_pending<1>();
        __syncthreads();
        issue(k + 2);
        // what the next level needs, on its way during this one's work
        const int kn = min(k + 1, k1 - 1);
        const long long ln = level_of(kn);
        T qn[S];
#pragma unroll
        for (int n = 0; n < S; ++n)
            qn[n] = __ldg(sc.a[n] + (long long)clampi(ks + k + 4, ks, ke - 1)
                                        * plane + o2);
        const T uLn = __ldg(u + ln + o2), uRn = __ldg(u + ln + o2_ip);
        const T vLn = __ldg(v + ln + o2), vRn = __ldg(v + ln + o2_jp);
        const T w1n = __ldg(w + ln + plane + o2);

        T c[7];
        vweights<UP>(rows + (k % K13_RR) * km::NCP,
                     rows + ((k + 1) % K13_RR) * km::NCP, w0, w1, c);
        const long long lev = level_of(k);
#pragma unroll
        for (int n = 0; n < S; ++n) {
            const T* P = ring + (n * K13_R + k % K13_R) * Sl::SIZE + me;
            const T q0 = q[n][3];
            T t = hdiv<C4, UP, T>([&](int d) { return d ? P[d] : q0; }, uR, uL) * dxi;
            t = t + hdiv<C4, UP, T>(
                        [&](int d) { return d ? P[d * km::RS] : q0; }, vR, vL) * dyi;
            T adv = c[0] * q[n][0];
#pragma unroll
            for (int m = 1; m < 7; ++m) adv = adv + c[m] * q[n][m];
            t = t + adv;
            if (inside) sc.ta[n][lev + o2] = sc.ta[n][lev + o2] + t;
        }
#pragma unroll
        for (int n = 0; n < S; ++n) {
#pragma unroll
            for (int m = 0; m < 6; ++m) q[n][m] = q[n][m + 1];
            q[n][6] = qn[n];
        }
        uL = uLn; uR = uRn; vL = vLn; vR = vRn; w0 = w1; w1 = w1n;
    }
    // no copy may land after the block has left its shared memory
    km::wait_all();
}

// dynamic shared memory of one K13 launch (ops/kmarch.py repeats it)
template <typename T>
constexpr size_t k13_smem(int S) {
    return ((size_t)S * K13_R * km::Slot<K13_TJ>::SIZE + K13_RR * km::NCP)
           * sizeof(T);
}

template <typename K>
static int raise_smem(K kernel, size_t smem) {
    return (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, bool C4, bool UP>
int launch_mom(const T* u, const T* v, const T* w, T* tu, T* tv, T* tw,
               const T* cc, int itot, int jtot, int ktot, int ks, double dxi,
               double dyi, int chunks, cudaStream_t stream) {
    const size_t smem = k12_smem<T>();
    if (int rc = raise_smem(advec_mom_kernel<T, C4, UP>, smem)) return rc;
    const bool vec = itot % (16 / (int)sizeof(T)) == 0 && km::aligned16(u)
                     && km::aligned16(v) && km::aligned16(w);
    const dim3 block(km::TI, K12_TJ);
    const dim3 grid((itot + km::TI - 1) / km::TI, (jtot + K12_TJ - 1) / K12_TJ,
                    chunks);
    advec_mom_kernel<T, C4, UP><<<grid, block, smem, stream>>>(
        u, v, w, tu, tv, tw, cc, itot, jtot, ktot, ks, T(dxi), T(dyi), chunks,
        (int)vec);
    return (int)cudaGetLastError();
}

template <typename T, bool C4, bool UP, int S>
int launch_scalars_s(const T* u, const T* v, const T* w,
                     const AdvScalars<T>& sc, const T* cc, int itot, int jtot,
                     int ktot, int ks, double dxi, double dyi, int chunks,
                     cudaStream_t stream) {
    const size_t smem = k13_smem<T>(S);
    if (int rc = raise_smem(advec_scalars_kernel<T, C4, UP, S>, smem)) return rc;
    bool vec = itot % (16 / (int)sizeof(T)) == 0;
    for (int n = 0; n < S; ++n) vec = vec && km::aligned16(sc.a[n]);
    const dim3 block(km::TI, K13_TJ);
    const dim3 grid((itot + km::TI - 1) / km::TI, (jtot + K13_TJ - 1) / K13_TJ,
                    chunks);
    advec_scalars_kernel<T, C4, UP, S><<<grid, block, smem, stream>>>(
        u, v, w, sc, cc, itot, jtot, ktot, ks, T(dxi), T(dyi), chunks,
        (int)vec);
    return (int)cudaGetLastError();
}

template <typename T, bool C4, bool UP>
int launch_scalars(const T* u, const T* v, const T* w, const AdvScalars<T>& sc,
                   int S, const T* cc, int itot, int jtot, int ktot, int ks,
                   double dxi, double dyi, int chunks, cudaStream_t stream) {
    switch (S) {
    case 1:
        return launch_scalars_s<T, C4, UP, 1>(u, v, w, sc, cc, itot, jtot,
                                              ktot, ks, dxi, dyi, chunks, stream);
    case 2:
        return launch_scalars_s<T, C4, UP, 2>(u, v, w, sc, cc, itot, jtot,
                                              ktot, ks, dxi, dyi, chunks, stream);
    case 3:
        return launch_scalars_s<T, C4, UP, 3>(u, v, w, sc, cc, itot, jtot,
                                              ktot, ks, dxi, dyi, chunks, stream);
    case 4:
        return launch_scalars_s<T, C4, UP, 4>(u, v, w, sc, cc, itot, jtot,
                                              ktot, ks, dxi, dyi, chunks, stream);
    }
    return (int)cudaErrorInvalidValue;
}

template <typename T, bool C4, bool UP>
int info_scalars(int S, int* out) {
    switch (S) {
    case 1:
        return km::kernel_info(advec_scalars_kernel<T, C4, UP, 1>, K13_NT,
                               k13_smem<T>(1), out);
    case 2:
        return km::kernel_info(advec_scalars_kernel<T, C4, UP, 2>, K13_NT,
                               k13_smem<T>(2), out);
    case 3:
        return km::kernel_info(advec_scalars_kernel<T, C4, UP, 3>, K13_NT,
                               k13_smem<T>(3), out);
    case 4:
        return km::kernel_info(advec_scalars_kernel<T, C4, UP, 4>, K13_NT,
                               k13_smem<T>(4), out);
    }
    return (int)cudaErrorInvalidValue;
}

// scheme: 0 = 2i4, 1 = 2i5, 2 = 2i53, 3 = 2i62 (ops/advec_interp_fused.py
// SCHEME_ID); 2i5 and 2i53 differ only in the table
template <typename T>
int advec_mom(const T* u, const T* v, const T* w, T* tu, T* tv, T* tw,
              const T* cc, int itot, int jtot, int ktot, int ks, int scheme,
              double dxi, double dyi, int chunks, cudaStream_t stream) {
    if (chunks < 1 || chunks > ktot) return (int)cudaErrorInvalidValue;
    switch (scheme) {
    case 0:
        return launch_mom<T, true, false>(u, v, w, tu, tv, tw, cc, itot, jtot,
                                          ktot, ks, dxi, dyi, chunks, stream);
    case 1:
    case 2:
        return launch_mom<T, false, true>(u, v, w, tu, tv, tw, cc, itot, jtot,
                                          ktot, ks, dxi, dyi, chunks, stream);
    case 3:
        return launch_mom<T, false, false>(u, v, w, tu, tv, tw, cc, itot, jtot,
                                           ktot, ks, dxi, dyi, chunks, stream);
    }
    return (int)cudaErrorInvalidValue;
}

template <typename T>
int advec_mom_info(int scheme, int* out) {
    switch (scheme) {
    case 0:
        return km::kernel_info(advec_mom_kernel<T, true, false>, K12_NT,
                               k12_smem<T>(), out);
    case 1:
    case 2:
        return km::kernel_info(advec_mom_kernel<T, false, true>, K12_NT,
                               k12_smem<T>(), out);
    case 3:
        return km::kernel_info(advec_mom_kernel<T, false, false>, K12_NT,
                               k12_smem<T>(), out);
    }
    return (int)cudaErrorInvalidValue;
}

template <typename T>
int advec_scalars(const T* u, const T* v, const T* w, const void* const* a,
                  void* const* ta, int S, const T* cc, int itot, int jtot,
                  int ktot, int ks, int scheme, double dxi, double dyi,
                  int chunks, cudaStream_t stream) {
    if (S < 1 || S > MAXA || chunks < 1 || chunks > ktot)
        return (int)cudaErrorInvalidValue;
    AdvScalars<T> sc;
    for (int n = 0; n < MAXA; ++n) {
        sc.a[n] = n < S ? (const T*)a[n] : nullptr;
        sc.ta[n] = n < S ? (T*)ta[n] : nullptr;
    }
    switch (scheme) {
    case 0:
        return launch_scalars<T, true, false>(u, v, w, sc, S, cc, itot, jtot,
                                              ktot, ks, dxi, dyi, chunks, stream);
    case 1:
    case 2:
        return launch_scalars<T, false, true>(u, v, w, sc, S, cc, itot, jtot,
                                              ktot, ks, dxi, dyi, chunks, stream);
    case 3:
        return launch_scalars<T, false, false>(u, v, w, sc, S, cc, itot, jtot,
                                               ktot, ks, dxi, dyi, chunks, stream);
    }
    return (int)cudaErrorInvalidValue;
}

template <typename T>
int advec_scalars_info(int scheme, int S, int* out) {
    switch (scheme) {
    case 0: return info_scalars<T, true, false>(S, out);
    case 1:
    case 2: return info_scalars<T, false, true>(S, out);
    case 3: return info_scalars<T, false, false>(S, out);
    }
    return (int)cudaErrorInvalidValue;
}

}  // namespace mhh

#define MHH_ADVEC_INTERP(SUF, T)                                              \
    extern "C" int mhh_advec_mom_##SUF(                                       \
        const void* u, const void* v, const void* w, void* tu, void* tv,      \
        void* tw, const void* cc, int itot, int jtot, int ktot, int ks,       \
        int scheme, double dxi, double dyi, int chunks, void* stream) {       \
        return mhh::advec_mom<T>((const T*)u, (const T*)v, (const T*)w,       \
                                 (T*)tu, (T*)tv, (T*)tw, (const T*)cc, itot,  \
                                 jtot, ktot, ks, scheme, dxi, dyi, chunks,    \
                                 (cudaStream_t)stream);                       \
    }                                                                         \
    extern "C" int mhh_advec_mom_info_##SUF(int scheme, int S, int* out) {    \
        (void)S;                                                              \
        return mhh::advec_mom_info<T>(scheme, out);                           \
    }                                                                         \
    extern "C" int mhh_advec_scalars_##SUF(                                   \
        const void* u, const void* v, const void* w, const void* const* a,    \
        void* const* ta, int S, const void* cc, int itot, int jtot, int ktot, \
        int ks, int scheme, double dxi, double dyi, int chunks,               \
        void* stream) {                                                       \
        return mhh::advec_scalars<T>((const T*)u, (const T*)v, (const T*)w,   \
                                     a, ta, S, (const T*)cc, itot, jtot,      \
                                     ktot, ks, scheme, dxi, dyi, chunks,      \
                                     (cudaStream_t)stream);                   \
    }                                                                         \
    extern "C" int mhh_advec_scalars_info_##SUF(int scheme, int S,            \
                                                int* out) {                   \
        return mhh::advec_scalars_info<T>(scheme, S, out);                    \
    }

MHH_ADVEC_INTERP(f32, float)
MHH_ADVEC_INTERP(f64, double)
