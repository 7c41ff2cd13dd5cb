"""Finite-difference coefficients (reference ``include/finite_difference.h``)."""


# --- 2nd order -------------------------------------------------------------

def interp2(a, b):
    return 0.5 * (a + b)


def interp22(a, b, c, d):
    return 0.25 * (a + b + c + d)


# --- 4th order -------------------------------------------------------------

ci0, ci1, ci2, ci3 = -1./16., 9./16., 9./16., -1./16.
bi0, bi1, bi2, bi3 = 5./16., 15./16., -5./16., 1./16.
ti0, ti1, ti2, ti3 = 1./16., -5./16., 15./16., 5./16.

cg0, cg1, cg2, cg3 = 1./24., -27./24., 27./24., -1./24.
bg0, bg1, bg2, bg3 = -23./24., 21./24., 3./24., -1./24.
tg0, tg1, tg2, tg3 = 1./24., -3./24., -21./24., 23./24.

cdg0, cdg1, cdg2, cdg3 = -1460./576., 783./576., -54./576., 1./576.


def interp4c(a, b, c, d):
    return ci0 * (a + d) + ci1 * (b + c)


def interp4b(a, b, c, d):
    return bi0 * a + bi1 * b - bi2 * c + bi3 * d


def interp4t(a, b, c, d):
    return ti0 * a + ti1 * b + ti2 * c + ti3 * d


def interp4_ws(a, b, c, d):
    return (7. / 12.) * (b + c) - (1. / 12.) * (a + d)


def interp3_ws(a, b, c, d):
    return (3. / 12.) * (c - b) - (1. / 12.) * (d - a)


def grad4(a, b, c, d):
    return -cg0 * (d - a) - cg1 * (c - b)


# --- 6th order -------------------------------------------------------------

def interp6_ws(a, b, c, d, e, f):
    return (37. / 60.) * (c + d) - (8. / 60.) * (b + e) + (1. / 60.) * (a + f)


def interp5_ws(a, b, c, d, e, f):
    return (10. / 60.) * (d - c) - (5. / 60.) * (e - b) + (1. / 60.) * (f - a)
