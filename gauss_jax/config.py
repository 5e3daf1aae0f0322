"""Configuration for gauss_jax analyses.

Mirrors the reference's ``Arguments`` struct including every hidden
hyperparameter default (reference: src/gauss.h:18-69, src/gauss.cpp:18-35)
so results are parity-comparable, plus device execution knobs the
reference has no analog for.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional


@dataclasses.dataclass
class Settings:
    """Hidden hyperparameters (reference: src/gauss.cpp:18-35)."""

    lambda_: float = 0.1          # ridge added to LD diagonal
    min_abs_eig: float = 1e-5     # eigenvalue clip in make_pos_def
    eig_cutoff: float = 0.01      # count_pc / rmv_pc threshold
    mix_af1_cutoff: float = 0.05
    interval: int = 1000
    min_num_measured_snp: int = 10
    min_num_unmeasured_snp: int = 10
    # JEPEG/MIX
    total_num_categ: int = 6
    categ_cor_cutoff: float = 0.8
    denorm_norm_w: int = 3
    imp_info_cutoff: float = 0.3


@dataclasses.dataclass
class ComputeOptions:
    """Device execution knobs (new; no reference analog).

    exact_combine:
        True  -> per-population sufficient statistics (integer-exact in
                 f32 on the device) are combined in float64, reproducing the
                 reference's C++ double arithmetic to the last bit of the
                 combine step.  Downstream dense linalg runs in float64.
        False -> everything stays in float32 on device (fast path).
    device_linalg:
        Run eigh/cholesky/solves on the accelerator (float32) instead of
        the host (float64).  Implied False when exact_combine is True.
    snp_block:
        Pad/tile size for SNP-axis blocking of windowed kernels.
    """

    exact_combine: bool = True
    device_linalg: bool = False
    snp_block: int = 256


DEFAULT_SETTINGS = Settings()
DEFAULT_COMPUTE = ComputeOptions()


@dataclasses.dataclass
class PanelFiles:
    """Paths to one reference panel in the reference wire format
    (SURVEY.md section 2.4)."""

    index_file: str
    data_file: str
    pop_desc_file: str
