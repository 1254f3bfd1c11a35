"""Global configuration: precision policy and solver defaults.

The Julia reference runs Float64 everywhere with ``abstol = reltol = 1e-9``
(`src/tracing/configuration.jl:1`). The framework is dtype-polymorphic: every
entry point follows the dtype of its inputs and the solver tolerances default
from it. Golden-parity tests run float64; the products run float32 with
loosened tolerances (float64 runs natively on the GPU too, at half the
float32 vector rate).
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp

__all__ = [
    "enable_x64",
    "default_float",
    "default_tols",
    "DEFAULT_ABSTOL_F64",
    "DEFAULT_ABSTOL_F32",
]

# Reference defaults (src/tracing/configuration.jl:1): abstol = reltol = 1e-9.
DEFAULT_ABSTOL_F64 = 1e-9
DEFAULT_RELTOL_F64 = 1e-9
# float32 has ~1.2e-7 eps; 1e-6 is the tightest tolerance that converges robustly.
DEFAULT_ABSTOL_F32 = 1e-6
DEFAULT_RELTOL_F32 = 1e-6

# Float32 matmuls/einsums may run in TF32 on the GPU, which keeps ~3 decimal
# digits — fine for neural nets, catastrophic for geodesic physics: every
# contraction in this framework is a tiny 4×4/2×2 (metric dots, LNRF
# transforms, conserved momenta), where ~3-digit rounding breaks Newton
# convergence in the offset solver and poisons redshifts (the CTF product
# degenerates to gmin == gmax under reduced-precision products). At these
# shapes full float32 costs nothing. The hot einsum sites ALSO pass
# precision=HIGHEST explicitly (so a user flipping this global back cannot
# silently break the integrator); this default protects everything else
# (jnp.linalg solves, user point functions).
#
# NOTE: this is a process-global side effect at import time — it also raises
# matmul precision (and lowers matmul throughput) for any co-resident JAX
# code, e.g. a neural-net model sharing the process. Documented in README;
# opt out with GRADUS_TPU_NO_GLOBAL_PRECISION=1 (the framework's own hot
# paths stay correct via their explicit per-site precision=HIGHEST).
if os.environ.get("GRADUS_TPU_NO_GLOBAL_PRECISION", "") != "1":
    jax.config.update("jax_default_matmul_precision", "highest")


def enable_x64(enable: bool = True) -> None:
    """Toggle 64-bit mode in JAX. Call before tracing anything."""
    jax.config.update("jax_enable_x64", enable)


def default_float():
    """The current default floating dtype (float64 iff x64 is enabled)."""
    return jnp.float64 if jax.config.jax_enable_x64 else jnp.float32


def default_tols(dtype=None):
    """(abstol, reltol) defaults for the given dtype."""
    if dtype is None:
        dtype = default_float()
    if jnp.dtype(dtype) == jnp.float64:
        return DEFAULT_ABSTOL_F64, DEFAULT_RELTOL_F64
    return DEFAULT_ABSTOL_F32, DEFAULT_RELTOL_F32


if os.environ.get("GRADUS_TPU_X64", "") == "1":  # pragma: no cover
    enable_x64(True)
