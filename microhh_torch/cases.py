"""Case input profiles computed in memory, for machines without h5py.

``rico_profiles(z)`` is a copy of the formulas of ``cases/rico/rico_input.py``
(the RICO composite of vanZanten et al. 2011, 'gcss' variant); the CPU tests
hold it equal, bit for bit, to the file that script writes.
``rico_input(ktot, zsize)`` wraps the profiles in the read side of a netCDF
dataset (``utils/nc.MemoryDataset``), which ``Model(..., input_nc=)`` takes.
``sbl_profiles`` and ``sbl_input`` do the same for ``cases/SBL_Smag/
SBL_input.py``.
"""

import numpy as np

from .utils.nc import MemoryDataset


def rico_profiles(z):
    """The init-group profiles of rico_input.nc at full levels z."""
    ktot = len(z)
    thl = np.where(z < 740., 297.9,
                   297.9 + (317.0 - 297.9) / (4000. - 740.) * (z - 740.))
    qt = np.where(z < 740., 16.0 + (13.8 - 16.0) / 740. * z,
                  np.where(z < 3260.,
                           13.8 + (2.4 - 13.8) / (3260. - 740.) * (z - 740.),
                           2.4 + (1.8 - 2.4) / (4000. - 3260.) * (z - 3260.)))
    qt *= 1e-3
    u = -9.9 + 2.0e-3 * z
    v = np.full(ktot, -3.8)
    wls = np.where(z < 2260., -0.005 * z / 2260., -0.005)
    thlls = np.full(ktot, -2.5 / 86400.)
    qtls = np.where(z < 2980., (-1.0 + 1.3456 * z / 2980.) / 86400., 4e-6)
    qtls *= 1e-3
    return {"thl": thl, "qt": qt, "u": u, "v": v, "u_geo": u, "v_geo": v,
            "w_ls": wls, "thl_ls": thlls, "qt_ls": qtls}


def rico_input(ktot, zsize):
    """The rico input dataset on the uniform grid of rico_input.py."""
    dz = zsize / ktot
    z = np.linspace(0.5 * dz, zsize - 0.5 * dz, ktot)
    return MemoryDataset({"z": z}, {"init": rico_profiles(z)})


def sbl_profiles(z, zsize):
    """The init-group profiles of SBL_input.nc at full levels z: the
    geostrophic wind and a linear stable stratification."""
    ktot = len(z)
    ug = np.full(ktot, 0.05)
    zero = np.zeros(ktot)
    return {"u": ug, "v": zero, "b": -0.0044 * (1. - z / zsize),
            "u_geo": ug, "v_geo": zero}


def sbl_input(ktot, zsize):
    """The SBL_Smag input dataset on the uniform grid of SBL_input.py."""
    dz = zsize / ktot
    z = np.linspace(0.5 * dz, zsize - 0.5 * dz, ktot)
    return MemoryDataset({"z": z}, {"init": sbl_profiles(z, zsize)})
