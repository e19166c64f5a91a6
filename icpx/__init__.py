"""icpx — point-cloud registration & odometry engine in JAX.

A brand-new JAX/XLA/Pallas implementation of the full capability surface of
the reference symmetric-ICP project (StephenNG59/ICP-symm, Rusinkiewicz 2019,
"A Symmetric Objective Function for ICP"): cloud I/O, normal estimation,
nearest-neighbor correspondence search, symmetric point-to-plane ICP with a
joint 6-DoF Gauss-Newton solve, closed-form Horn/Kabsch registration —
extended with sharded/distributed execution, voxel-hash NN,
multi-resolution pyramids, odometry and a pose-graph backend.

Reference layer map: /root/reference/ICP/{myicp.cpp,func.cpp,regist.h};
see SURVEY.md for the full blueprint.
"""

import jax as _jax

# Registration is a numerics-sensitive domain with tiny contraction dims
# (K=3 distance cross-terms, K=6 normal equations): reduced-precision
# matmul passes (bf16, or TF32 on NVIDIA GPUs, ~10 mantissa bits) corrupt
# correspondence distances and solves (coordinate magnitudes ~1e2 lose 3
# decimal digits), while true fp32 costs nearly nothing at these K.
_jax.config.update("jax_default_matmul_precision", "highest")

from icpx.cloud import PointCloud
from icpx.geometry.se3 import SE3
from icpx.registration.icp import ICPConfig, ICPResult, register
from icpx.registration.horn import horn_align
from icpx.registration.pyramid import PyramidConfig, register_pyramid
from icpx.io.loaders import load_cloud, save_cloud

__version__ = "0.1.0"

__all__ = [
    "PointCloud",
    "SE3",
    "ICPConfig",
    "ICPResult",
    "register",
    "horn_align",
    "PyramidConfig",
    "register_pyramid",
    "load_cloud",
    "save_cloud",
    "__version__",
]
