"""Case input profiles computed in memory, for machines without h5py.

``rico_profiles(z)`` is a copy of the formulas of ``cases/rico/rico_input.py``
(the RICO composite of vanZanten et al. 2011, 'gcss' variant); the CPU tests
hold it equal, bit for bit, to the file that script writes.
``rico_input(ktot, zsize)`` wraps the profiles in the read side of a netCDF
dataset (``utils/nc.MemoryDataset``), which ``Model(..., input_nc=)`` takes.
``sbl_profiles`` and ``sbl_input`` do the same for ``cases/SBL_Smag/
SBL_input.py`` (byte for byte the SBL_input.py of SBL_DNN,
SBL_DNNglobalScales and SBL_DNNstatsScales, whose ini is SBL.ini too), ``moser180_input`` for ``cases/moser180/moser180_input.py``
and ``weakscaling_input`` for ``cases/weakscaling/weakscaling_input.py``,
``jaenschwalde_input`` for ``cases/jaenschwalde/jaenschwalde_input.py``,
``sullivan2011_input`` for ``cases/sullivan2011/sullivan2011_input.py`` and
``andren1994_input`` for ``cases/andren1994/andren1994_input.py``,
``drycblles_input`` for ``cases/drycblles/drycblles_input.py`` and
``bomex_input`` for ``cases/bomex/bomex_input.py``; the 4th-order DNS
cases ``drycbl_input``, ``prandtlslope_input``, ``rayleighbenard_input``,
``rayleightaylor_input`` and ``moser600_input``; and the cases with a
``timedep`` group (series over ``time_surface`` and ``time_ls``, which
``timedep.py`` reads): ``gabls1_input``, ``gabls4s3_input`` (the idealized
Dome C stand-in that ``gabls4s3_input.py`` writes when the GABLS4 driver
file ``SCM_LES_STAGE3.nc`` is absent) and ``arm_input``; ``eady_input`` for
``cases/eady/eady_input.py``; the 2-D 4th-order DNS cases
``drycblslope_input`` and ``vanheerwaarden2016_input`` and the laminar
``ekman_input``.  A case whose
script fixes its levels takes that count as its default ``ktot`` and
ignores ``zsize``: its ini's zsize is the height those levels give.
"""

import numpy as np

from .utils.nc import MemoryDataset


def uniform_z(ktot, zsize):
    """Full levels of a uniform grid, as the cases' input scripts set them."""
    dz = zsize / ktot
    return np.linspace(0.5 * dz, zsize - 0.5 * dz, ktot)


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
    z = uniform_z(ktot, zsize)
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
    z = uniform_z(ktot, zsize)
    return MemoryDataset({"z": z}, {"init": sbl_profiles(z, zsize)})


def moser180_input(ktot, zsize):
    """The input dataset of cases/moser180/moser180_input.py: the tanh-
    stretched wall-normal grid of the Re_tau = 180 channel, the laminar
    parabola for u and a scalar equal to z."""
    alpha = 0.967
    k = np.arange(ktot)
    eta = -1. + 2. * ((k + 1) - 0.5) / ktot
    z = (zsize / (2. * alpha)
         * np.tanh(eta * 0.5 * (np.log(1. + alpha) - np.log(1. - alpha)))
         + 0.5 * zsize)
    dpdxls = -1.5e-6
    visc = 1.0e-5
    u = 1. / (2. * visc) * dpdxls * (z ** 2 - zsize * z)
    return MemoryDataset({"z": z}, {"init": {"u": u, "v": np.zeros(ktot),
                                             "s": z.copy()}})


def tanh_stretched_z(kmax, nloc1, nbuf1, nloc2, nbuf2, dz1, dz2, dz3):
    """The doubly tanh-stretched levels of cases/weakscaling/
    weakscaling_input.py and the domain height they give."""
    dn = 1. / kmax
    n = np.linspace(dn, 1. - dn, kmax)
    dzdn = (dz1 / dn
            + 0.5 * (dz2 - dz1) / dn * (1. + np.tanh((n - nloc1 * dn) / (nbuf1 * dn)))
            + 0.5 * (dz3 - dz2) / dn * (1. + np.tanh((n - nloc2 * dn) / (nbuf2 * dn))))
    dz = dzdn * dn
    z = np.empty(kmax)
    z[0] = 0.5 * dz[0]
    for k in range(1, kmax):
        z[k] = z[k - 1] + 0.5 * (dz[k - 1] + dz[k])
    return z, z[-1] + 0.5 * dz[-1]


def weakscaling_input(ktot=1024):
    """The input dataset of cases/weakscaling/weakscaling_input.py (1024
    stretched levels, b = N2 z) and the zsize its stretching gives.  Another
    ktot scales the stretching to that many levels over the same height."""
    f = ktot / 1024.
    z, zsize = tanh_stretched_z(ktot, nloc1=160. * f, nbuf1=32. * f,
                                nloc2=1024. * f, nbuf2=144. * f,
                                dz1=0.0005 / f, dz2=0.001 / f, dz3=0.01 / f)
    return MemoryDataset({"z": z}, {"init": {"b": 3. * z}}), zsize


def jaenschwalde_profiles(z):
    """The init-group profiles of jaenschwalde_input.nc at full levels z:
    piecewise-linear soundings, no CO2 at the start and none flowing in."""
    ktot = len(z)
    thl = np.interp(z, [0., 400., 2000., 2500., 5000.],
                    [285.7, 291.9, 293.0, 297.4, 307.0])
    qt = np.interp(z, [0., 400., 2000., 2500., 5000.],
                   np.array([6.2, 4.93, 3.61, 1.0, 0.3]) / 1000.)
    u = np.interp(z, [0., 5000.], [3., 7.])
    return {"thl": thl, "qt": qt, "u": u, "v": np.zeros(ktot),
            "co2": np.zeros(ktot), "co2_inflow": np.zeros(ktot)}


def jaenschwalde_input(ktot, zsize=5000.):
    """The jaenschwalde input dataset on the uniform grid of
    jaenschwalde_input.py."""
    z = uniform_z(ktot, zsize)
    return MemoryDataset({"z": z}, {"init": jaenschwalde_profiles(z)})


def sullivan2011_profiles(z):
    """The init-group profiles of sullivan2011_input.nc at full levels z:
    a mixed layer under a capping inversion near 1 km, a weak geostrophic
    wind."""
    kmax = len(z)
    th = np.where(z <= 974., 300.,
                  np.where(z <= 1074., 300. + (z - 974.) * 0.08,
                           308. + (z - 1074.) * 0.003))
    return {"th": th, "u": np.ones(kmax), "u_geo": np.ones(kmax),
            "v_geo": np.zeros(kmax)}


def sullivan2011_input(ktot, zsize=2048.):
    """The sullivan2011 input dataset on the uniform grid of
    sullivan2011_input.py."""
    z = uniform_z(ktot, zsize)
    return MemoryDataset({"z": z}, {"init": sullivan2011_profiles(z)})


def andren1994_profiles(z):
    """The init-group profiles of andren1994_input.nc at full levels z: the
    neutral Ekman layer of Andren et al. (1994), a geostrophic wind of 10
    m/s along x and a passive scalar that starts at zero."""
    kmax = len(z)
    return {"u": np.full(kmax, 10.), "v": np.zeros(kmax),
            "u_geo": np.full(kmax, 10.), "v_geo": np.zeros(kmax),
            "s": np.zeros(kmax)}


def andren1994_input(ktot, zsize=1500.):
    """The andren1994 input dataset on the uniform grid of
    andren1994_input.py."""
    z = uniform_z(ktot, zsize)
    return MemoryDataset({"z": z}, {"init": andren1994_profiles(z)})


def drycblles_profiles(z):
    """The init-group profiles of drycblles_input.nc at full levels z: a
    linearly stratified dry layer at rest."""
    kmax = len(z)
    return {"u": np.zeros(kmax), "v": np.zeros(kmax), "th": 300. + 0.003 * z}


def drycblles_input(ktot, zsize=1200.):
    """The drycblles input dataset on the uniform grid of
    drycblles_input.py."""
    z = uniform_z(ktot, zsize)
    return MemoryDataset({"z": z}, {"init": drycblles_profiles(z)})


def bomex_profiles(z):
    """The init-group profiles of bomex_input.nc at full levels z: the
    piecewise-linear BOMEX soundings and forcings (Siebesma et al. 2003)."""
    thl = np.interp(z, [0., 520., 1480., 2000., 3000.],
                    [298.7, 298.7, 302.4, 308.2, 311.85])
    qt = 1e-3 * np.interp(z, [0., 520., 1480., 2000., 3000.],
                          [17.0, 16.3, 10.7, 4.2, 3.0])
    u = np.interp(z, [0., 700., 3000.], [-8.75, -8.75, -4.61])
    ugeo = -10. + 1.8e-3 * z
    wls = np.interp(z, [0., 1500., 2100., 3000.], [0., -0.65, 0., 0.]) / 100.
    thlls = np.interp(z, [0., 1500., 3000.], [-2., -2., 0.]) / 86400.
    qtls = np.interp(z, [0., 300., 500., 3000.], [-1.2, -1.2, 0., 0.]) * 1.e-8
    return {"thl": thl, "qt": qt, "u": u, "v": np.zeros_like(z),
            "u_geo": ugeo, "v_geo": np.zeros_like(z), "w_ls": wls,
            "thl_ls": thlls, "qt_ls": qtls}


def bomex_input(ktot, zsize=3000.):
    """The bomex input dataset on the uniform grid of bomex_input.py."""
    z = uniform_z(ktot, zsize)
    return MemoryDataset({"z": z}, {"init": bomex_profiles(z)})


def drycbl_input(ktot=128, zsize=None):
    """The input dataset of cases/drycbl/drycbl_input.py: its doubly tanh-
    stretched levels (the stretching placed by level, so that another ktot
    keeps its shape over ktot levels) and b = 3 z."""
    kmax = ktot
    dn = 1. / kmax
    n = np.linspace(dn, 1. - dn, kmax)
    nloc1, nbuf1 = 20. * dn, 4. * dn
    nloc2, nbuf2 = 128. * dn, 18. * dn
    dz1, dz2, dz3 = 0.004, 0.008, 0.064
    dzdn1 = dz1 / dn
    dzdn2 = dz2 / dn
    dzdn3 = dz3 / dn
    dzdn = (dzdn1 + 0.5 * (dzdn2 - dzdn1) * (1. + np.tanh((n - nloc1) / nbuf1))
            + 0.5 * (dzdn3 - dzdn2) * (1. + np.tanh((n - nloc2) / nbuf2)))
    dz = dzdn * dn
    z = np.zeros(kmax)
    z[0] = 0.5 * dz[0]
    for k in range(1, kmax):
        z[k] = z[k - 1] + 0.5 * (dz[k - 1] + dz[k])
    return MemoryDataset({"z": z}, {"init": {"b": 3. * z}})


def prandtlslope_input(ktot=256, zsize=None):
    """The input dataset of cases/prandtlslope/prandtlslope_input.py: levels
    stretched geometrically from dz = 0.002 over a height of 1, at rest."""
    kmax = ktot
    dz1 = 0.002
    r = 1.01
    for _ in range(50):
        r = (1. - (1. / dz1) * (1. - r)) ** (1. / kmax)
    dz = dz1 * r ** np.arange(kmax)
    z = np.zeros(kmax)
    z[0] = 0.5 * dz[0]
    for k in range(1, kmax):
        z[k] = z[k - 1] + 0.5 * (dz[k - 1] + dz[k])
    return MemoryDataset({"z": z}, {"init": {"b": np.zeros(kmax)}})


def rayleighbenard_input(ktot=128, zsize=0.5):
    """The input dataset of cases/rayleighbenard/rayleighbenard_input.py:
    no buoyancy between the plates at the start."""
    z = uniform_z(ktot, zsize)
    return MemoryDataset({"z": z}, {"init": {"b": np.zeros(ktot)}})


def rayleightaylor_input(ktot=128, zsize=0.5):
    """The input dataset of cases/rayleightaylor/rayleightaylor_input.py:
    heavy fluid (b = -1) over light (b = 1)."""
    z = uniform_z(ktot, zsize)
    b = np.where(z > 0.5 * zsize, -1., 1.)
    return MemoryDataset({"z": z}, {"init": {"b": b}})


def moser600_input(ktot=128, zsize=2.):
    """The input dataset of cases/moser600/moser600_input.py, whose formulas
    are moser180_input.py's."""
    return moser180_input(ktot, zsize)


def gabls1_input(ktot=64, zsize=400.):
    """The input dataset of cases/gabls1/gabls1_input.py: 265 K below 100 m
    and 0.01 K/m above, a geostrophic wind of 8 m/s, and the surface cooling
    of 0.25 K/h as the series th_sbot over time_surface."""
    z = uniform_z(ktot, zsize)
    th = np.where(z <= 100., 265., 265. + 0.01 * (z - 100.))
    u = np.full(ktot, 8.)
    zero = np.zeros(ktot)
    return MemoryDataset({"z": z}, {
        "init": {"th": th, "u": u, "v": zero, "u_geo": u, "v_geo": zero},
        "timedep": {"time_surface": np.array([0., 32400.]),
                    "th_sbot": np.array([265., 262.75])}})


def gabls4s3_z(kmax):
    """The two-zone tanh levels of cases/gabls4s3/gabls4s3_input.py (fine
    near the surface, ~955 m at its 288 levels)."""
    nloc1, nbuf1, dz1, dz2 = 250., 20., 2., 12.
    dn = 1. / kmax
    n = np.linspace(dn, 1. - dn, kmax)
    dzdn = dz1 / dn + 0.5 * (dz2 - dz1) / dn * (
        1. + np.tanh((n - nloc1 * dn) / (nbuf1 * dn)))
    dz = dzdn * dn
    z = np.empty(kmax)
    z[0] = 0.5 * dz[0]
    for k in range(1, kmax):
        z[k] = z[k - 1] + 0.5 * (dz[k - 1] + dz[k])
    return z


def gabls4s3_input(ktot=288, zsize=None):
    """The input dataset that cases/gabls4s3/gabls4s3_input.py writes
    without the GABLS4 driver file: the idealized Dome C stand-in (th 270 K
    at the surface rising 8 K over 100 m, 0.0078 K/m above; u = ug = 4.6
    m/s) with the diurnal surface temperature 278 -> 270 -> 278 K as th_sbot
    over time_surface, hourly for 24 h."""
    z = gabls4s3_z(ktot)
    th = 278. + np.maximum(z - 100., 0.) * 0.0078
    th = np.where(z < 100., 270. + 8. * z / 100., th)
    u = np.full(ktot, 4.6)
    zero = np.zeros(ktot)
    t_srf = np.linspace(0., 86400., 25)
    ths = 274. - 4. * np.cos(2. * np.pi * t_srf / 86400.)
    return MemoryDataset({"z": z}, {
        "init": {"th": th, "u": u, "v": zero, "u_geo": np.full(ktot, 4.6),
                 "v_geo": np.zeros(ktot)},
        "timedep": {"time_surface": t_srf, "th_sbot": ths}})


def arm_input(ktot=64, zsize=4400.):
    """The input dataset of cases/arm/arm_input.py (Brown et al. 2002):
    piecewise-linear soundings, the surface fluxes of heat and moisture as
    series over time_surface, and the large-scale thl and qt tendencies as
    profiles over time_ls."""
    z = uniform_z(ktot, zsize)
    zb = np.array([0., 50., 350., 650., 700., 1300., 2500., 5500.])
    thlb = np.array([299.0, 301.5, 302.5, 303.53, 303.7, 307.13, 314.0, 343.2])
    qtb = np.array([15.20, 15.17, 14.98, 14.80, 14.70, 13.50, 3.00, 3.00])
    thl = np.interp(z, zb, thlb)
    qt = np.interp(z, zb, qtb) * 1e-3
    u = np.full(ktot, 10.)
    time_sfc = np.array([0., 4., 6.5, 7.5, 10., 12.5, 14.5]) * 3600.
    H = np.array([-30., 90., 140., 140., 100., -10., -10.])
    LE = np.array([5., 250., 450., 500., 420., 180., 0.])
    rho0 = 97000. / (287. * thl[0] * (1. + 0.61 * qt[0]))
    time_ls = np.array([0., 3., 6., 9., 12., 14.5]) * 3600.
    advthl = np.array([0., 0., 0., -0.08, -0.16, -0.16])
    radthl = np.array([-0.125, 0., 0., 0., 0., -0.1])
    advqt = np.array([0.08, 0.02, -0.04, -0.10, -0.16, -0.30])
    ramp = np.where(z <= 1000., 1., 1. - (z - 1000.) / (5500. - 1000.))
    return MemoryDataset({"z": z}, {
        "init": {"thl": thl, "qt": qt, "u": u, "u_geo": u,
                 "v": np.zeros(ktot), "v_geo": np.zeros(ktot)},
        "timedep": {
            "time_surface": time_sfc,
            "thl_sbot": H / (rho0 * 1005.),
            "qt_sbot": LE / (rho0 * 2.5e6),
            "time_ls": time_ls,
            "thl_ls": (advthl + radthl)[:, None] / 3600. * ramp[None, :],
            "qt_ls": advqt[:, None] / 3600. * 1e-3 * ramp[None, :]}})


def eady_input(ktot=32, zsize=1000.):
    """The eady input dataset of eady_input.py: a geostrophic wind in
    thermal-wind balance with the meridional th gradient, u_geo = -g/(fc
    th0) dth/dy z, and a weakly stratified th."""
    z = uniform_z(ktot, zsize)
    fc, th0, dthdy = 1e-2, 300., -1e-4
    ug = -9.81 / (fc * th0) * dthdy * z
    return MemoryDataset({"z": z}, {"init": {
        "th": 300. + 0.01 * z, "u": ug, "v": np.zeros(ktot), "u_geo": ug,
        "v_geo": np.zeros(ktot)}})


def drycblslope_z(ktot=512):
    """The levels of cases/drycblslope/drycblslope_input.py (512 doubly
    tanh-stretched levels) and the domain height they give; another ktot
    scales the stretching to that many levels, as weakscaling_input does."""
    f = ktot / 512.
    return tanh_stretched_z(ktot, nloc1=80. * f, nbuf1=16. * f,
                            nloc2=512. * f, nbuf2=72. * f, dz1=0.001 / f,
                            dz2=0.002 / f, dz3=0.016 / f)


def drycblslope_input(ktot=512, zsize=None):
    """The input dataset of cases/drycblslope/drycblslope_input.py: its
    stretched levels (drycblslope_z) and b = N2 z with N2 = 3.  The ini's
    zsize is the height the levels give."""
    z, _ = drycblslope_z(ktot)
    return MemoryDataset({"z": z}, {"init": {"b": 3. * z}})


def tanh_stretched_z_dn(kmax, dn, nloc1, nbuf1, nloc2, nbuf2, dz1, dz2, dz3):
    """The tanh-stretched levels of cases/vanheerwaarden2016/
    vanheerwaarden2016_input.py, whose resolution parameter dn is set apart
    from the level count, and the domain height they give."""
    n = np.linspace(dn, 1. - dn, kmax)
    dzdn = (dz1 / dn
            + 0.5 * (dz2 - dz1) / dn * (1. + np.tanh((n - nloc1 * dn) / (nbuf1 * dn)))
            + 0.5 * (dz3 - dz2) / dn * (1. + np.tanh((n - nloc2 * dn) / (nbuf2 * dn))))
    dz = dzdn * dn
    z = np.empty(kmax)
    z[0] = 0.5 * dz[0]
    for k in range(1, kmax):
        z[k] = z[k - 1] + 0.5 * (dz[k - 1] + dz[k])
    return z, z[-1] + 0.5 * dz[-1]


def vanheerwaarden2016_z(ktot=384):
    """The levels of cases/vanheerwaarden2016/vanheerwaarden2016_input.py
    (384 levels at dn = 1/512) and the domain height they give; another
    ktot scales the spacings by 384 / ktot, which keeps the stretching's
    shape over about the same height."""
    dn = 1. / 512.
    f = 384. / ktot
    return tanh_stretched_z_dn(ktot, dn, nloc1=80., nbuf1=24., nloc2=512.,
                               nbuf2=72., dz1=0.5 * dn * f, dz2=dn * f,
                               dz3=5. * dn * f)


def vanheerwaarden2016_input(ktot=384, zsize=None):
    """The input dataset of cases/vanheerwaarden2016/
    vanheerwaarden2016_input.py: its stretched levels
    (vanheerwaarden2016_z) and b = N2 z with N2 = 3."""
    z, _ = vanheerwaarden2016_z(ktot)
    return MemoryDataset({"z": z}, {"init": {"b": 3. * z}})


def ekman_input(ktot=64, zsize=5.):
    """The input dataset of cases/ekman/ekman_input.py: the run starts from
    the geostrophic wind, u = u_geo = 1 and v = v_geo = 0."""
    z = uniform_z(ktot, zsize)
    one, zero = np.ones(ktot), np.zeros(ktot)
    return MemoryDataset({"z": z}, {"init": {"u": one, "v": zero,
                                             "u_geo": one.copy(),
                                             "v_geo": zero.copy()}})


def case_input(casename, ktot, zsize):
    """The input dataset of the shipped case ``casename`` (its ini's file
    name) at ktot levels over zsize, computed in memory as its
    ``<case>_input.py`` writes it (weakscaling, whose stretching sets zsize
    itself, is ``weakscaling_input``); None for a case without an input
    script, whose ini sets its fields (taylorgreen, conservation)."""
    if casename in ("taylorgreen", "conservation"):
        return None
    make = {"drycblles": drycblles_input, "bomex": bomex_input,
            "rico": rico_input, "SBL": sbl_input,
            "moser180": moser180_input, "jaenschwalde": jaenschwalde_input,
            "sullivan2011": sullivan2011_input,
            "andren1994": andren1994_input, "drycbl": drycbl_input,
            "prandtlslope": prandtlslope_input,
            "rayleighbenard": rayleighbenard_input,
            "rayleightaylor": rayleightaylor_input,
            "moser600": moser600_input, "gabls1": gabls1_input,
            "gabls4s3": gabls4s3_input, "arm": arm_input,
            "eady": eady_input, "drycblslope": drycblslope_input,
            "vanheerwaarden2016": vanheerwaarden2016_input,
            "ekman": ekman_input}
    if casename not in make:
        raise ValueError("no input of case %r in microhh_torch.cases"
                         % casename)
    return make[casename](ktot, zsize)
