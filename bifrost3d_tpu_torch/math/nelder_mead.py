"""Nelder-Mead downhill-simplex minimizer — counterpart of
``Math/NelderMead.h``.

A copy of ``bifrost3d_tpu/math/nelder_mead.py`` (numpy, on the host): the
scalar minimizer. The batched one that fits the LTC table on the device
is ``shading/ltc_fit._batched_nelder_mead``."""

from __future__ import annotations

import numpy as np


def nelder_mead(f, x0, step: float = 0.1, max_iterations: int = 200,
                tolerance: float = 1e-8):
    """Minimize f: R^n → R from x0. Returns (x_best, f_best).

    Standard reflection/expansion/contraction/shrink coefficients
    (1, 2, 0.5, 0.5), matching the reference's implementation.
    """
    x0 = np.asarray(x0, np.float64)
    n = x0.size
    simplex = [x0]
    for i in range(n):
        xi = x0.copy()
        xi[i] += step
        simplex.append(xi)
    values = [f(x) for x in simplex]

    for _ in range(max_iterations):
        order = np.argsort(values)
        simplex = [simplex[i] for i in order]
        values = [values[i] for i in order]
        if abs(values[-1] - values[0]) < tolerance:
            break
        centroid = np.mean(simplex[:-1], axis=0)

        reflected = centroid + (centroid - simplex[-1])
        fr = f(reflected)
        if values[0] <= fr < values[-2]:
            simplex[-1], values[-1] = reflected, fr
            continue
        if fr < values[0]:
            expanded = centroid + 2.0 * (centroid - simplex[-1])
            fe = f(expanded)
            if fe < fr:
                simplex[-1], values[-1] = expanded, fe
            else:
                simplex[-1], values[-1] = reflected, fr
            continue
        contracted = centroid + 0.5 * (simplex[-1] - centroid)
        fc = f(contracted)
        if fc < values[-1]:
            simplex[-1], values[-1] = contracted, fc
            continue
        # Shrink toward the best vertex.
        for i in range(1, n + 1):
            simplex[i] = simplex[0] + 0.5 * (simplex[i] - simplex[0])
            values[i] = f(simplex[i])

    best = int(np.argmin(values))
    return simplex[best], values[best]
