// K1: strain rate squared and the stability-corrected Smagorinsky eddy
// viscosity on the interior levels (diff_smag2.cxx calc_strain2 +
// calc_evisc).
//
// Replaces the TPU kernel FusedLES2.evisc / _evisc_body
// (microhh_tpu/ops/pallas_fused.py:1417, pallas_call :1441), full-plane
// variant, in its two modes.  ghosts = 0 (the dry path, fold_ghosts): the
// fields are read raw and the k index of each neighbour plane is clamped
// (u, v, th to [ks, ke-1], w to [ks, ke]), which equals the ghost value for
// the zero-gradient top BCs.  ghosts = 1 (the generic path): the fields
// are ghost-filled and read at k-1 and k+1 as they are; the stratified
// term is then the moist N2 of thl against thvref (model.py:964-970).  The
// MOST wall row is patched afterwards in torch (ops/fused.py
// surface_evisc_row).
//
// K14: the same eddy viscosity with the buoyancy frequency N2 read from an
// interior (ktot, jtot, itot) field that the thermodynamics computed
// (thermo buoy's background N2, thermo dry on the generic path) instead of
// taken from a scalar's gradient: stratified = 2, the th argument is then
// that field, read at the point.  Replaces FusedLES2.evisc_n2 /
// _evisc_n2_body (pallas_fused.py:1480, pallas_call :1496); it runs on
// ghost-filled fields.  Its entry is mhh_evisc_n2; K1 and K14 are one
// body, evisc_kernel<T, ST> with ST the stratified mode.
//
// K7: the adaptive-dt limits pass, the per-level maxima of the CFL rate
// (advec_2.cxx:50-78 pointwise expression) and of the same eddy viscosity,
// in one read of u, v, w (and th or N2 when stratified) and with no
// field-sized write.  Replaces FusedLES2.limits_pass / _limits_body
// (pallas_fused.py:1502, pallas_call :1524), in every mode of K1 and K14
// (ghosts 0 and 1, stratified 0, 1 and 2); the per-level dt factors and the
// MOST row are applied by the caller on the (ktot,) maxima, as the JAX
// package does.
//
// Bound: device-memory bytes.  Per output point K1 does ~100 flops on 4
// field reads and 1 write (~20 B in f32), far below the H100's ~20 flop/B
// balance; K7 ~110 on the reads alone.
//
// The design (the k-march of kmarch.cuh, as K8/K9's in tend_generic.cu),
// one march for K1/K14 (evisc_kernel<T, ST>) and K7 (limits_kernel<T, ST>),
// evisc_march<T, ST, LIM>, LIM the K7 epilogue.  A block of EV_TJ warps
// owns an (EV_TJ, 32) tile and marches one chunk [k0, k1) of the levels
// (chunk_bounds; ops/kmarch.py picks the count from the resident blocks,
// so that the grid fills the card in whole waves).
// * Group p is plane p of u, v and w side by side in one ring slot
//   (Slot<EV_TJ, 1>: the strain rate reaches one cell across the plane),
//   copied by cp.async (16 bytes where the tile lies inside the plane) at
//   PlaneLoader's offsets, shared by the three fields; in clamped mode w's
//   plane index is clamped to [ks, ke] and u's and v's to [ks, ke-1].  The
//   table row of level p is staged beside it and one thread divides its
//   grav/thref quotient once a level (QRow, EQ_GTHREF).  Five slots: groups
//   k-1, k, k+1 read, k+2 landing, k+3 being filled; one commit group and
//   one barrier a level.  A chunk issues group k0-1 first and plane k1 last.
// * A thread keeps its own column of u, v, w (k-1 .. k+1) in registers (KV
//   views of the slots); th is never a ring plane: with ST 1 the thread
//   loads th at its own point a level ahead and keeps th(k-1 .. k+1) in
//   registers, with ST 2 it loads N2(k) at its point a level ahead, with ST
//   0 it reads no th.
// * The point function is les_math.cuh's evisc_math, as K22 calls it.
// * Everything is periodic, so a partial tile computes its virtual points
//   (their offsets wrapped) like any other.  K1 only guards its stores; the
//   output goes from registers to out, a warp's 32 values in a row, so out
//   may be an interior view of a kcells tensor.
// * K7 adds the CFL rate, whose u(i+1), v(j+1) and w(k+1) are in the same
//   group slots and column, and takes each level's two maxima instead of
//   storing: every thread writes its two rates to a shared array
//   double-buffered by level parity; after level k's barrier, which the
//   march has anyway, warps 0 and 1 fold level k-1's rates (one rate each:
//   a lane the rates of eight neighbouring threads, then the lanes by
//   shuffles), and the chunk's last level after a barrier of its own, into
//   the tile's slot of a (2, ktot, tiles) partial array (each (level, tile)
//   belongs to one chunk).  Each warp reducing its own rates by shuffles
//   instead took 439 against 394 SASS a warp and level and 1.461 against
//   1.296 ms at drycblles 512^3 on an H100 at 700 W.  A second small kernel
//   takes the maximum over the tiles, so the result does not depend on the
//   order in which blocks finish.  The maxima keep a NaN, as jnp.max does.
#include "kmarch.cuh"
#include "les_math.cuh"

#include <type_traits>

namespace mhh {

// max that keeps a NaN, as jnp.max does (one max.NaN in float32)
__device__ __forceinline__ float nanmax(float a, float b) {
    float d;
    asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
    return d;
}

__device__ __forceinline__ double nanmax(double a, double b) {
    return (a != a || a > b) ? a : b;
}

// the maximum of eight values at x (16-byte aligned)
__device__ __forceinline__ float max8(const float* x) {
    const float4 a = reinterpret_cast<const float4*>(x)[0];
    const float4 b = reinterpret_cast<const float4*>(x)[1];
    return nanmax(nanmax(nanmax(a.x, a.y), nanmax(a.z, a.w)),
                  nanmax(nanmax(b.x, b.y), nanmax(b.z, b.w)));
}

__device__ __forceinline__ double max8(const double* x) {
    const double2* v = reinterpret_cast<const double2*>(x);
    const double2 a = v[0], b = v[1], c = v[2], d = v[3];
    return nanmax(nanmax(nanmax(a.x, a.y), nanmax(b.x, b.y)),
                  nanmax(nanmax(c.x, c.y), nanmax(d.x, d.y)));
}

template <typename T>
__device__ __forceinline__ T warp_max(T x) {
    for (int off = 16; off > 0; off >>= 1)
        x = nanmax(x, __shfl_xor_sync(0xffffffffu, x, off));
    return x;
}

// out[row] = max over the nblk partial maxima of row (2*ktot rows)
template <typename T>
__global__ void __launch_bounds__(256)
limits_reduce(const T* __restrict__ part, T* __restrict__ out, long long nblk) {
    __shared__ T red[256 / 32];
    const T* row = part + (long long)blockIdx.x * nblk;
    T m = T(0);
    for (long long q = threadIdx.x; q < nblk; q += blockDim.x)
        m = nanmax(m, row[q]);
    m = warp_max(m);
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = m;
    __syncthreads();
    if (threadIdx.x == 0) {
        for (int q = 1; q < 256 / 32; ++q) m = nanmax(m, red[q]);
        out[blockIdx.x] = m;
    }
}

// ---- K1/K14 and K7: the k-march ----

constexpr int EV_TJ = 8;                 // tile rows (32 x EV_TJ threads)
constexpr int EV_NT = km::TI * EV_TJ;
constexpr int EV_HALO = 1;               // the strain rate's reach
constexpr int EV_NF = 3;                 // fields a group: u, v, w
constexpr int EV_R = 5;                  // group slots: k-1 .. k+3
constexpr int EV_NCP = 8;                // values a staged row
static_assert(NEQ <= EV_NCP, "the staged row holds ce and its quotient");
static_assert(EV_NT == 32 * 8, "a folding lane takes eight threads' rates");

// everything a launch takes but its template arguments
template <typename T>
struct EviscArgs {
    const T *u, *v, *w;
    const T* th;        // the scalar (ST 1), the interior N2 (ST 2), unread
    T* out;             // (ktot, jtot, itot); K7's (2, ktot, tiles) partials
    const T* ce;        // (ktot, NE)
    int itot, jtot, ktot, ks;
    T dxi, dyi, tPr;
    int ghosts, chunks, vec_ok;
};

// dynamic shared memory of one launch (ops/kmarch.py repeats it): EV_R
// groups of u's, v's and w's planes and a staged table row a group
template <typename T>
constexpr size_t evisc_smem() {
    return ((size_t)EV_R * EV_NF * km::Slot<EV_TJ, EV_HALO>::SIZE
            + (size_t)EV_R * EV_NCP) * sizeof(T);
}

// K7's: K1's and the two rates of each thread for two levels
template <typename T>
constexpr size_t limits_smem() {
    return evisc_smem<T>() + (size_t)2 * 2 * EV_NT * sizeof(T);
}

extern __shared__ __align__(16) unsigned char evisc_smem_buf[];

// the CFL rate at the views' point of the plane in slot q.kc (advec_2
// cfl_max's pointwise expression): u(i+1), v(j+1) and w(k+1) are in the
// group slots and the column that evisc_math reads
template <typename T, typename VF>
__device__ __forceinline__ T cfl_rate(const VF& U, const VF& V, const VF& W,
                                      Slots q, T dxi, T dyi, T dzi) {
    const T half = T(0.5);
    return fabs(half * (U(q.kc, 0, 0) + U(q.kc, 0, 1))) * dxi
           + fabs(half * (V(q.kc, 0, 0) + V(q.kc, 1, 0))) * dyi
           + fabs(half * (W(q.kc, 0, 0) + W(q.kp, 0, 0))) * dzi;
}

// The march of one chunk of one tile: K1/K14 (LIM false) store the eddy
// viscosity at the tile's own points; K7 (LIM true) reduces it and the CFL
// rate to the tile's per-level maxima.  The arguments come by value: taken
// by reference to the kernel's parameter, they gave K1 other SASS (its
// registers and the unrolling of its copies), though not other results.
template <typename T, int ST, bool LIM>
__device__ __forceinline__ void evisc_march(const EviscArgs<T> a) {
    using Sl = km::Slot<EV_TJ, EV_HALO>;
    constexpr int SZ = Sl::SIZE, PL = EV_NF * SZ;
    T* const ring = reinterpret_cast<T*>(evisc_smem_buf);   // [R][NF][SZ]
    T* const rows = ring + EV_R * PL;                        // [R][NCP]
    const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * km::TI + tx;
    const int i0 = blockIdx.x * km::TI, j0 = blockIdx.y * EV_TJ;
    const bool inside = i0 + tx < a.itot && j0 + ty < a.jtot;
    int k0, k1;
    km::chunk_bounds(blockIdx.z, a.chunks, a.ktot, k0, k1);
    const long long plane = (long long)a.itot * a.jtot;
    const km::PlaneLoader<T, EV_TJ, EV_NT, EV_HALO> ld(
        tid, i0, j0, a.itot, a.jtot, a.vec_ok && i0 + km::TI <= a.itot);
    // the point, wrapped where the tile passes the plane's edge (only its
    // store is guarded), in the plane and in a slot
    const long long o2 =
        (long long)wrap(j0 + ty, a.jtot) * a.itot + wrap(i0 + tx, a.itot);
    const int me = (ty + EV_HALO) * km::RS + tx + km::C0;
    // the level of plane p: u's, v's and th's clamped to [lo, hic], w's to
    // [lo, ke] (lo = ks, hic = ke-1 in clamped mode; lo = ks-1, hic = ke,
    // the ghost planes as they are, in ghost mode)
    const int ke = a.ks + a.ktot;
    const int lo = a.ghosts ? a.ks - 1 : a.ks, hic = a.ghosts ? ke : ke - 1;
    auto level = [&](int p) {
        return (long long)clampi(a.ks + p, lo, hic) * plane;
    };
    auto level_w = [&](int p) {
        return (long long)clampi(a.ks + p, lo, ke) * plane;
    };
    auto next = [](int s) { return s == EV_R - 1 ? 0 : s + 1; };

    // group p into slot s: plane p of u, v and w (the loader's offsets
    // shared by the three) and, for a level of the chunk, table row p; none
    // past plane k1 (an empty group keeps the count)
    auto issue = [&](int p, int s) {
        if (p <= k1) {
            const long long lc = level(p), lw = level_w(p);
            T* const sl = ring + s * PL;
#pragma unroll
            for (int n = 0; n < ld.NOP; ++n) {
                if (ld.src[n] < 0) continue;
                T* const d = sl + (ld.dst[n] & (km::VEC - 1));
                const long long g = lc + ld.src[n], gw = lw + ld.src[n];
                if (ld.dst[n] & km::VEC) {
                    km::cp_async<16>(d, a.u + g);
                    km::cp_async<16>(d + SZ, a.v + g);
                    km::cp_async<16>(d + 2 * SZ, a.w + gw);
                } else {
                    km::cp_async<sizeof(T)>(d, a.u + g);
                    km::cp_async<sizeof(T)>(d + SZ, a.v + g);
                    km::cp_async<sizeof(T)>(d + 2 * SZ, a.w + gw);
                }
            }
            if (p >= k0 && p < k1 && tid < NE)
                km::cp_async<sizeof(T)>(rows + s * EV_NCP + tid,
                                        a.ce + (long long)p * NE + tid);
        }
        km::commit();
    };
    // the quotient of the staged row in slot s (QRow's EQ_GTHREF), divided
    // as evisc_math would divide it, by one thread
    auto derive = [&](int s) {
        if (ST == 1 && tid == 0) {
            T* const r = rows + s * EV_NCP;
            r[EQ_GTHREF] = T(9.81) / r[E_THREF];
        }
    };
    // th at the thread's own point of plane p (ST 1), N2 at level k (ST 2)
    auto th_at = [&](int p) { return __ldg(a.th + level(p) + o2); };
    auto n2_at = [&](int k) {
        return __ldg(a.th + (long long)k * plane + o2);
    };
    // K7: the threads' rates of level k lie in red[k & 1] (the CFL rate's,
    // then the eddy viscosity's, in thread order); warp r folds rate r,
    // each lane the rates of eight neighbouring threads and the lanes by
    // shuffles, into the tile's partial of level k
    T* const red = rows + EV_R * EV_NCP;                     // [2][2][NT]
    auto fold = [&](int k) {
        if (ty < 2) {
            const T m = warp_max(max8(red + ((k & 1) * 2 + ty) * EV_NT
                                      + 8 * tx));
            const long long tiles = (long long)gridDim.x * gridDim.y;
            const long long tile =
                (long long)blockIdx.y * gridDim.x + blockIdx.x;
            if (tx == 0)
                a.out[((long long)ty * a.ktot + k) * tiles + tile] = m;
        }
    };

    // group p lives in slot (p - k0 + 1) mod EV_R
    issue(k0 - 1, 0);
    issue(k0, 1);
    issue(k0 + 1, 2);
    issue(k0 + 2, 3);
    T a0 = T(0), a1 = T(0), a2 = T(0), n2 = T(0);
    if (ST == 1) {
        a0 = th_at(k0 - 1);
        a1 = th_at(k0);
        a2 = th_at(k0 + 1);
    }
    if (ST == 2) n2 = n2_at(k0);
    km::wait_pending<2>();      // groups k0-1 and k0 have landed
    __syncthreads();
    derive(1);
    // the register columns at k0-1 and k0 (w's plane k-1 is never read)
    T u0 = ring[me], v0 = ring[me + SZ];
    T u1 = ring[PL + me], v1 = ring[PL + me + SZ], w1 = ring[PL + me + 2 * SZ];
    const Slots q{0, 1, 2};
    int sm = 0;                 // the slot of group k-1
    for (int k = k0; k < k1; ++k) {
        km::wait_pending<1>();  // group k+1 has landed
        __syncthreads();
        const int sc = next(sm), sp = next(sc);
        // group k+3 goes where group k-2 lay, which nothing reads any more
        issue(k + 3, sm == 0 ? EV_R - 1 : sm - 1);
        // the quotient of row k+1, which landed with its group
        if (k + 1 < k1) derive(sp);
        // th and N2 of the next level, on their way during this one
        T an = T(0), n2n = T(0);
        if (ST == 1) an = th_at(min(k + 2, k1));
        if (ST == 2) n2n = n2_at(min(k + 1, k1 - 1));
        // K7: level k-1's rates, which its threads wrote before the barrier
        if (LIM && k > k0) fold(k - 1);

        const T* const pm = ring + sm * PL + me;
        const T* const pc = ring + sc * PL + me;
        const T* const pp = ring + sp * PL + me;
        const T u2 = pp[0], v2 = pp[SZ], w2 = pp[2 * SZ];
        const KV<T, km::RS> U{pm, pc, pp, u0, u1, u2};
        const KV<T, km::RS> V{pm + SZ, pc + SZ, pp + SZ, v0, v1, v2};
        const KV<T, km::RS> W{pm + 2 * SZ, pc + 2 * SZ, pp + 2 * SZ, w1, w1,
                              w2};
        // th: its own column only
        const KV<T, km::RS> A{nullptr, nullptr, nullptr, a0, a1, a2};
        const T ev = evisc_math<QRow<T>>(U, V, W, A, q,
                                         QRow<T>{rows + sc * EV_NCP}, a.dxi,
                                         a.dyi, a.tPr, ST, n2);
        if constexpr (LIM) {
            // a partial tile's virtual points are real grid points (their
            // offsets wrapped), so they may enter the maxima
            const T cfl = cfl_rate(U, V, W, q, a.dxi, a.dyi,
                                   rows[sc * EV_NCP + E_DZI]);
            red[(k & 1) * 2 * EV_NT + tid] = cfl;
            red[((k & 1) * 2 + 1) * EV_NT + tid] = ev;
        } else {
            if (inside) a.out[(long long)k * plane + o2] = ev;
        }
        u0 = u1; u1 = u2;
        v0 = v1; v1 = v2;
        w1 = w2;
        a0 = a1; a1 = a2; a2 = an;
        n2 = n2n;
        sm = sc;
    }
    if constexpr (LIM) {
        // the chunk's last level, after a barrier of its own
        __syncthreads();
        fold(k1 - 1);
    }
    // no copy may land after the block has left its shared memory
    km::wait_all();
}

// five blocks an SM in float32 (at most 51 registers: 0.567 against 0.601
// ms with four at rico 384^3, 1.305 against 1.412 clamped at drycblles
// 512^3 on an H100 at 700 W; six, at 40 registers and 8 B of spill, ran
// 5% slower than four), three in float64
template <typename T, int ST>
__global__ void __launch_bounds__(EV_NT, sizeof(T) == 4 ? 5 : 3)
evisc_kernel(const EviscArgs<T> a) {
    evisc_march<T, ST, false>(a);
}

// K7: the march with its maxima, as many blocks an SM as K1
template <typename T, int ST>
__global__ void __launch_bounds__(EV_NT, sizeof(T) == 4 ? 5 : 3)
limits_kernel(const EviscArgs<T> a) {
    evisc_march<T, ST, true>(a);
}

// f(integral_constant ST) for the stratified mode ST
template <typename F>
int evisc_form(int stratified, F f) {
    using std::integral_constant;
    switch (stratified) {
    case 0: return f(integral_constant<int, 0>());
    case 1: return f(integral_constant<int, 1>());
    case 2: return f(integral_constant<int, 2>());
    }
    return (int)cudaErrorInvalidValue;
}

// the arguments of a K1/K14 or K7 launch (out: K7's partials)
template <typename T>
EviscArgs<T> evisc_args(const T* u, const T* v, const T* w, const T* th,
                        T* out, const T* ce, int itot, int jtot, int ktot,
                        int ks, double dxi, double dyi, double tPr,
                        int ghosts, int chunks) {
    EviscArgs<T> a;
    a.u = u; a.v = v; a.w = w; a.th = th; a.out = out; a.ce = ce;
    a.itot = itot; a.jtot = jtot; a.ktot = ktot; a.ks = ks;
    a.dxi = T(dxi); a.dyi = T(dyi); a.tPr = T(tPr);
    a.ghosts = ghosts; a.chunks = chunks;
    a.vec_ok = itot % (16 / (int)sizeof(T)) == 0 && km::aligned16(u)
               && km::aligned16(v) && km::aligned16(w);
    return a;
}

// one launch of a march kernel: tiles x chunks blocks
template <typename T, typename K>
int launch_march(K kernel, const EviscArgs<T>& a, size_t smem,
                 cudaStream_t stream) {
    int rc = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc) return rc;
    const dim3 block(km::TI, EV_TJ);
    const dim3 grid((a.itot + km::TI - 1) / km::TI,
                    (a.jtot + EV_TJ - 1) / EV_TJ, a.chunks);
    kernel<<<grid, block, smem, stream>>>(a);
    return (int)cudaGetLastError();
}

template <typename T>
int launch_evisc(const T* u, const T* v, const T* w, const T* th, T* out,
                 const T* ce, int itot, int jtot, int ktot, int ks, double dxi,
                 double dyi, double tPr, int stratified, int ghosts,
                 int chunks, cudaStream_t stream) {
    if (chunks < 1 || chunks > ktot) return (int)cudaErrorInvalidValue;
    const EviscArgs<T> a = evisc_args(u, v, w, th, out, ce, itot, jtot, ktot,
                                      ks, dxi, dyi, tPr, ghosts, chunks);
    return evisc_form(stratified, [&](auto st) {
        return launch_march(evisc_kernel<T, decltype(st)::value>, a,
                            evisc_smem<T>(), stream);
    });
}

template <typename T>
int evisc_info(int stratified, int* out) {
    return evisc_form(stratified, [&](auto st) {
        return km::kernel_info(evisc_kernel<T, decltype(st)::value>, EV_NT,
                               evisc_smem<T>(), out);
    });
}

// part: (2, ktot, tiles) scratch, tiles = ceil(itot/32) * ceil(jtot/EV_TJ);
// out: (2, ktot) per-level maxima of the CFL rate and the eddy viscosity
template <typename T>
int launch_limits(const T* u, const T* v, const T* w, const T* th, T* part,
                  T* out, const T* ce, int itot, int jtot, int ktot, int ks,
                  double dxi, double dyi, double tPr, int stratified,
                  int ghosts, int chunks, cudaStream_t stream) {
    if (chunks < 1 || chunks > ktot) return (int)cudaErrorInvalidValue;
    const EviscArgs<T> a = evisc_args(u, v, w, th, part, ce, itot, jtot,
                                      ktot, ks, dxi, dyi, tPr, ghosts, chunks);
    const int rc = evisc_form(stratified, [&](auto st) {
        return launch_march(limits_kernel<T, decltype(st)::value>, a,
                            limits_smem<T>(), stream);
    });
    if (rc) return rc;
    const long long tiles = (long long)((itot + km::TI - 1) / km::TI)
                            * ((jtot + EV_TJ - 1) / EV_TJ);
    limits_reduce<T><<<2 * ktot, 256, 0, stream>>>(part, out, tiles);
    return (int)cudaGetLastError();
}

template <typename T>
int limits_info(int stratified, int* out) {
    return evisc_form(stratified, [&](auto st) {
        return km::kernel_info(limits_kernel<T, decltype(st)::value>, EV_NT,
                               limits_smem<T>(), out);
    });
}

}  // namespace mhh

#define MHH_EVISC(SUF, T)                                                     \
    extern "C" int mhh_evisc_##SUF(                                           \
        const void* u, const void* v, const void* w, const void* th,          \
        void* out, const void* ce, int itot, int jtot, int ktot, int ks,      \
        double dxi, double dyi, double tPr, int stratified, int ghosts,       \
        int chunks, void* stream) {                                           \
        return mhh::launch_evisc<T>((const T*)u, (const T*)v, (const T*)w,    \
                                    (const T*)th, (T*)out, (const T*)ce,      \
                                    itot, jtot, ktot, ks, dxi, dyi, tPr,      \
                                    stratified, ghosts, chunks,               \
                                    (cudaStream_t)stream);                    \
    }                                                                         \
    extern "C" int mhh_evisc_n2_##SUF(                                        \
        const void* u, const void* v, const void* w, const void* n2,          \
        void* out, const void* ce, int itot, int jtot, int ktot, int ks,      \
        double dxi, double dyi, double tPr, int chunks, void* stream) {       \
        return mhh::launch_evisc<T>((const T*)u, (const T*)v, (const T*)w,    \
                                    (const T*)n2, (T*)out, (const T*)ce,      \
                                    itot, jtot, ktot, ks, dxi, dyi, tPr, 2,   \
                                    1, chunks, (cudaStream_t)stream);         \
    }                                                                         \
    extern "C" int mhh_evisc_info_##SUF(int scheme, int S, int* out) {        \
        return mhh::evisc_info<T>(scheme, out);                               \
    }                                                                         \
    extern "C" int mhh_limits_##SUF(                                          \
        const void* u, const void* v, const void* w, const void* th,          \
        void* part, void* out, const void* ce, int itot, int jtot, int ktot,  \
        int ks, double dxi, double dyi, double tPr, int stratified,           \
        int ghosts, int chunks, void* stream) {                               \
        return mhh::launch_limits<T>((const T*)u, (const T*)v, (const T*)w,   \
                                     (const T*)th, (T*)part, (T*)out,         \
                                     (const T*)ce, itot, jtot, ktot, ks, dxi, \
                                     dyi, tPr, stratified, ghosts, chunks,    \
                                     (cudaStream_t)stream);                   \
    }                                                                         \
    extern "C" int mhh_limits_info_##SUF(int scheme, int S, int* out) {       \
        return mhh::limits_info<T>(scheme, out);                              \
    }

MHH_EVISC(f32, float)
MHH_EVISC(f64, double)
