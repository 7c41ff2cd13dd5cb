"""The k-march plan of the redesigned ring kernels K13 (``advec_scalars``)
and K16 (``o4_mom``): the host's copy of ``csrc/kmarch.cuh`` and of the two
kernels' shared-memory layouts.

A launch is a grid of (tiles in i) x (tiles in j) x chunks blocks; block z
marches the levels ``chunk_bounds(chunks, ktot)[z]``.  ``plan`` picks the
chunk count from the card's resident slots (blocks an SM, which the C side
reports through ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``, times
the SMs) so that the blocks fill the card in whole waves: the count that
minimises waves x (levels a chunk + the six planes a chunk reads again to
warm its column up).  The shared-memory formulas repeat the kernels' own
(``k13_smem``, ``K16<T>::smem``), and a CPU test holds the constants here
to those in the sources.
"""

import collections
import functools

import torch

# csrc/kmarch.cuh
TI, H, C0, RS, NCP = 32, 3, 4, 40, 28
SMEM_MAX = 232448           # bytes of shared memory a block can have
WARM = 6                    # planes a chunk reads to warm its column up

# csrc/advec_interp.cu: K13_TJ, K13_R, K13_RR, MAXA
K13_TJ, K13_R, K13_RR, K13_MAXS = 8, 3, 4, 4
# csrc/o4.cu: K16_TJ, NI (interpolant planes)
K16_TJ, K16_NI = 8, 8

Plan = collections.namedtuple("Plan", "tiles_i tiles_j chunks smem slots waves")


def _bytes(dtype):
    return torch.finfo(dtype).bits // 8


def slot_size(tj):
    """Values of one haloed plane of a (tj, TI) tile (kmarch.cuh Slot)."""
    return (tj + 2 * H) * RS


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


SMEM = {"advec_scalars": lambda S, dtype: k13_smem(S, dtype),
        "o4_mom": lambda S, dtype: k16_smem(dtype)}
TILE_J = {"advec_scalars": K13_TJ, "o4_mom": K16_TJ}


def chunk_bounds(chunks, ktot):
    """[k0, k1) of each chunk (kmarch.cuh chunk_bounds)."""
    return [(z * ktot // chunks, (z + 1) * ktot // chunks)
            for z in range(chunks)]


@functools.lru_cache(maxsize=256)
def choose_chunks(tiles, ktot, slots):
    """The chunk count that minimises waves x (levels a chunk + WARM)."""
    best, best_cost = 1, None
    for chunks in range(1, ktot + 1):
        waves = -(-tiles * chunks // slots)
        cost = waves * (-(-ktot // chunks) + WARM)
        if best_cost is None or cost < best_cost:
            best, best_cost = chunks, cost
    return best


def plan(kernel, itot, jtot, ktot, S, dtype, slots, chunks=None):
    """The launch of K13 ("advec_scalars", S scalars) or K16 ("o4_mom"):
    tiles, chunk count (chosen from slots, the card's resident blocks,
    unless given), shared memory a block and the waves it makes."""
    tiles_i = -(-itot // TI)
    tiles_j = -(-jtot // TILE_J[kernel])
    if chunks is None:
        chunks = choose_chunks(tiles_i * tiles_j, ktot, slots)
    if not 1 <= chunks <= ktot:
        raise ValueError("chunks must lie in [1, ktot = %d], not %d"
                         % (ktot, chunks))
    waves = -(-tiles_i * tiles_j * chunks // slots)
    return Plan(tiles_i, tiles_j, chunks, SMEM[kernel](S, dtype), slots,
                waves)
