"""6D spatial-inertia helpers (Featherstone convention), numpy, build time.

The part of `mqe_tpu/physics/spatial.py` that the model loader needs: model
constants are computed once in numpy (float64) and reach the device either as
python floats folded into the plain dynamics (physics/soa.py) or as the
float32 model table of the CUDA kernel (physics/model.py::model_tables).

Motion vectors m = (angular, linear); force vectors F = (torque, force), both
expressed at a frame origin.
"""
from __future__ import annotations

import numpy as np


def skew(v) -> np.ndarray:
    """(3,) -> (3, 3) cross-product matrix, skew(a) @ b = a x b."""
    x, y, z = (float(c) for c in v)
    return np.array([[0.0, -z, y], [z, 0.0, -x], [-y, x, 0.0]])


def spatial_inertia(mass, com, inertia_com) -> np.ndarray:
    """6x6 spatial inertia at the body-frame origin.

    I = [[I_com + m c^ c^T, m c^], [m c^T, m E]], acting on (w, v) -> (n, f).
    """
    C = skew(com)
    m = float(mass)
    out = np.zeros((6, 6))
    out[:3, :3] = np.asarray(inertia_com) + m * (C @ C.T)
    out[:3, 3:] = m * C
    out[3:, :3] = m * C.T
    out[3:, 3:] = m * np.eye(3)
    return out
