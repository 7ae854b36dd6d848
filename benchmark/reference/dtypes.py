"""Precision policy of the reference.

Every float is float32, the precision the configurations state.
``ZWRT_REFERENCE_DTYPE=bfloat16``, read at import, computes in bfloat16
instead: the control that the comparison has to reject
(``benchmark/control.py``).  The constants are Python floats holding the
float32 value, so they combine with float32 tensors without promoting them
(a Python scalar never widens a tensor's dtype, a numpy float64 array
would).
"""

import os

import numpy as np
import torch

# Compute dtype for all geometry/shading math.
real = getattr(torch, os.environ.get("ZWRT_REFERENCE_DTYPE", "float32"))
real_np = np.float32

# 4-ULP MaxMult robustness factor for the f32 AABB slab test.
AABB_MAX_MULT = float(np.float32(1.00000024))

# t_min used when tracing bounce rays (shadow-acne epsilon).
T_MIN = float(np.float32(1e-3))

# Running best t of the closest-hit stages before any hit (finite, so the
# slab test's far clip stays finite) and the identity sentinel of a leaf
# sweep; a stage that found nothing reports INF.
BIG = float(np.float32(3.0e38))
BIG_IDX = 2**30

# t_min used inside light-PDF evaluation re-traces.
T_MIN_PDF = float(np.float32(1e-3))

# Parallel-ray epsilon in the quad plane test.
QUAD_PARALLEL_EPS = float(np.float32(1e-8))

INF = float("inf")

# Largest float strictly below 1.0 in f32.
ONE_MINUS_EPS = float(np.nextafter(np.float32(1.0), np.float32(0.0)))

# Rec.709 luminance weights.
LUM_R = float(np.float32(0.2126))
LUM_G = float(np.float32(0.7152))
LUM_B = float(np.float32(0.0722))
