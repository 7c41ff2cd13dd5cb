"""Physical constants (reference ``include/constants.h``)."""

kappa = 0.4            # von Karman constant
grav = 9.81            # gravitational acceleration [m s-2]
e_rot = 7.2921e-5      # earth rotation rate [s-1]
Rd = 287.04            # gas constant dry air [J K-1 kg-1]
Rv = 461.5             # gas constant water vapor [J K-1 kg-1]
cp = 1005.             # specific heat at constant pressure [J kg-1 K-1]
Lv = 2.501e6           # latent heat of vaporization [J kg-1]
Lf = 3.337e5           # latent heat of fusion [J kg-1]
Ls = Lv + Lf           # latent heat of sublimation [J kg-1]
T0 = 273.15            # freezing temperature [K]
p0 = 1.e5              # reference pressure [Pa]
ep = Rd / Rv
rho_w = 1.e3           # density of water [kg m-3]
rho_i = 7.e2           # density of ice [kg m-3]
mu0_min = 1e-6
sigma_b = 5.67e-8      # Stefan-Boltzmann
xmair = 28.9647

zL_max = 10.           # Obukhov-length limits
zL_min = -1.e4

dsmall = 1.e-9
dbig = 1.e9
dhuge = 1.e30
ulhuge = (1 << 64) - 1
