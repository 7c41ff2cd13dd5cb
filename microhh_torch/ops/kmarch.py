"""The k-march plan of the redesigned ring kernels K13 (``advec_scalars``),
K16 (``o4_mom``), K17 (``o4_scalars``), the scalar sweep K10
(``tend_scalars``) / K19 (``tend_scalar_acc``) and the folded dry sweep K22
(``tend_rk_fold``): the host's copy of ``csrc/kmarch.cuh`` and of the
kernels' shared-memory layouts.

A launch is a grid of (tiles in i) x (tiles in j) x chunks blocks; block z
marches the levels ``chunk_bounds(chunks, ktot)[z]``.  ``plan`` picks the
chunk count from the card's resident slots (blocks an SM, which the C side
reports through ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``, times
the SMs) so that the blocks fill the card in whole waves: the count that
minimises waves x (levels a chunk + the planes a chunk reads again to warm
its column up).  The shared-memory formulas repeat the kernels' own
(``k13_smem``, ``K16<T>::smem``, ``k17_smem``, ``sweep_smem``,
``fold_smem``), and a CPU test holds the constants here to those in the
sources.
"""

import collections
import functools

import torch

# csrc/kmarch.cuh
TI, H, C0, RS, NCP = 32, 3, 4, 40, 28
SMEM_MAX = 232448           # bytes of shared memory a block can have

# csrc/advec_interp.cu: K13_TJ, K13_R, K13_RR, MAXA
K13_TJ, K13_R, K13_RR, K13_MAXS = 8, 3, 4, 4
# csrc/o4.cu: K16_TJ, NI (interpolant planes); K17_TJ, K17_R, K17_RR,
# K17_MAXS, K17_NCP
K16_TJ, K16_NI = 8, 8
K17_TJ, K17_R, K17_RR, K17_MAXS, K17_NCP = 8, 3, 3, 4, 40
# csrc/tend_generic.cu: SW_TJ, SW_HALO, SW_R, SW_MAXS, NTGP; NTG of
# csrc/les_math.cuh (ops/fused.py NTG)
SW_TJ, SW_HALO, SW_R, SW_MAXS, NTGP, NTG = 8, 1, 3, 4, 24, 21
# csrc/tend_rk_fold.cu: K22_TJ, K22_HALO, K22_R, K22_ER, K22_EW, K22_NTC
K22_TJ, K22_HALO, K22_R, K22_ER, K22_EW, K22_NTC = 8, 2, 6, 4, TI + 2, 32

Plan = collections.namedtuple("Plan", "tiles_i tiles_j chunks smem slots waves")


def _bytes(dtype):
    return torch.finfo(dtype).bits // 8


def slot_size(tj, halo=H):
    """Values of one haloed plane of a (tj, TI) tile (kmarch.cuh Slot)."""
    return (tj + 2 * halo) * RS


def k13_smem(S, dtype):
    """Dynamic shared memory of a K13 launch of S scalars."""
    return (S * K13_R * slot_size(K13_TJ) + K13_RR * NCP) * _bytes(dtype)


def k16_geom(dtype):
    """K16's prefetch distance and ring depths (csrc/o4.cu K16<T>)."""
    D = 2 if dtype == torch.float32 else 1
    return {"D": D, "RU": 4 + D, "RW": 3 + D, "RD": 1 + D, "RR": 8,
            "IR": K16_TJ + 3, "IC": TI + 4}


def k16_smem(dtype):
    """Dynamic shared memory of a K16 launch."""
    g = k16_geom(dtype)
    planes = 2 * g["RU"] + g["RW"] + g["RD"]
    return ((planes * slot_size(K16_TJ) + K16_NI * g["IR"] * g["IC"]
             + g["RR"] * NCP) * _bytes(dtype))


def k17_smem(S, dtype):
    """Dynamic shared memory of a K17 launch of S scalars: K17_R slots of
    each scalar's, u's and v's plane and K17_RR staged table rows."""
    return (((S + 2) * K17_R * slot_size(K17_TJ) + K17_RR * K17_NCP)
            * _bytes(dtype))


def sweep_smem(S, dtype, rk, advec):
    """Dynamic shared memory of a scalar-sweep launch of S scalars
    (csrc/tend_generic.cu sweep_smem): three slots of each scalar's, e's
    and, with advection, u's and v's plane, and three staged table rows a
    scalar with the RK fold (one shared row without)."""
    fields = S + 1 + (2 if advec else 0)
    return ((fields * SW_R * slot_size(SW_TJ, SW_HALO)
             + SW_R * (S if rk else 1) * NTGP) * _bytes(dtype))


def fold_smem(dtype):
    """Dynamic shared memory of a K22 launch (csrc/tend_rk_fold.cu
    fold_smem): K22_R slots of the four fields' planes, K22_ER of e's
    (the tile plus one), u* and v* of two levels with the column and row
    beyond the tile, and a staged table row a field slot."""
    return ((K22_R * 4 * slot_size(K22_TJ, K22_HALO)
             + K22_ER * (K22_TJ + 2) * K22_EW
             + 2 * K22_TJ * (TI + 1) + 2 * (K22_TJ + 1) * TI
             + K22_R * K22_NTC) * _bytes(dtype))


# kernel -> shared memory of a launch (S, dtype, advec)
SMEM = {"advec_scalars": lambda S, dtype, advec: k13_smem(S, dtype),
        "o4_mom": lambda S, dtype, advec: k16_smem(dtype),
        "o4_scalars": lambda S, dtype, advec: k17_smem(S, dtype),
        "tend_scalars": lambda S, dtype, advec: sweep_smem(S, dtype, True,
                                                           advec),
        "tend_scalar_acc": lambda S, dtype, advec: sweep_smem(S, dtype, False,
                                                              advec),
        "tend_rk_fold": lambda S, dtype, advec: fold_smem(dtype)}
TILE_J = {"advec_scalars": K13_TJ, "o4_mom": K16_TJ, "o4_scalars": K17_TJ,
          "tend_scalars": SW_TJ, "tend_scalar_acc": SW_TJ,
          "tend_rk_fold": K22_TJ}
# planes a chunk reads again to warm its column up: K13's, K16's and K17's
# seven-plane windows; the sweep's column k0-1..k0+1 and the plane past it;
# K22's planes k0-2, k0-1 below the chunk (with e(k0-1)) and w's tendency
# at k1 above it
WARM = {"advec_scalars": 6, "o4_mom": 6, "o4_scalars": 6, "tend_scalars": 2,
        "tend_scalar_acc": 2, "tend_rk_fold": 2}


def chunk_bounds(chunks, ktot):
    """[k0, k1) of each chunk (kmarch.cuh chunk_bounds)."""
    return [(z * ktot // chunks, (z + 1) * ktot // chunks)
            for z in range(chunks)]


@functools.lru_cache(maxsize=256)
def choose_chunks(tiles, ktot, slots, warm):
    """The chunk count that minimises waves x (levels a chunk + warm)."""
    best, best_cost = 1, None
    for chunks in range(1, ktot + 1):
        waves = -(-tiles * chunks // slots)
        cost = waves * (-(-ktot // chunks) + warm)
        if best_cost is None or cost < best_cost:
            best, best_cost = chunks, cost
    return best


def plan(kernel, itot, jtot, ktot, S, dtype, slots, chunks=None,
         advec=True):
    """The launch of K13 ("advec_scalars", S scalars), K16 ("o4_mom"), K17
    ("o4_scalars", S scalars), the scalar sweep ("tend_scalars" K10,
    "tend_scalar_acc" K19; S scalars, advec its flag) or K22
    ("tend_rk_fold"): tiles, chunk count (chosen from slots, the card's
    resident blocks, unless given), shared memory a block and the waves it
    makes."""
    tiles_i = -(-itot // TI)
    tiles_j = -(-jtot // TILE_J[kernel])
    if chunks is None:
        chunks = choose_chunks(tiles_i * tiles_j, ktot, slots, WARM[kernel])
    if not 1 <= chunks <= ktot:
        raise ValueError("chunks must lie in [1, ktot = %d], not %d"
                         % (ktot, chunks))
    waves = -(-tiles_i * tiles_j * chunks // slots)
    return Plan(tiles_i, tiles_j, chunks, SMEM[kernel](S, dtype, advec),
                slots, waves)
