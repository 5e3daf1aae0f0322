"""gauss_jax: GWAS summary-statistics engine on JAX (GPU).

A from-scratch JAX/XLA/Pallas rebuild of the capabilities of
statsleelab/gauss (GAUSS, "Genome Analysis Using Summary Statistics"):
Z-score imputation (dist/distmix), ancestry-weighted LD
(compute_ld/simulate_ld), ancestry-proportion estimation
(afmix/cpw2/zmix + prep_zmix family), per-SNP causality tests
(qcat/qcatmix + preps), gene-level TWAS (jepeg/jepegmix) and winner's-
curse correction (fiqt).

Design: the reference panel is decoded once into HBM-resident int8
dosage matrices; every correlation kernel is a matmul (centered
cancellation-free f32 on the fused device path, integer-exact f32
sufficient statistics + f64 combines on the host parity path); windows
and genes run data-parallel over a jax.sharding.Mesh with the subject
axis sharded via psum.
"""

# float64 combines require x64; set before any JAX computation.
import os as _os

import jax as _jax

_jax.config.update("jax_enable_x64", True)

# Persistent compilation cache: windowed analyses reuse a handful of
# bucketed kernel shapes across processes; caching them makes every run
# after the first start in seconds.  JAX itself honours
# JAX_COMPILATION_CACHE_DIR; without it the cache lives at a fixed path
# inside the checkout (the path is part of the cache key).
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _jax.config.update(
        "jax_compilation_cache_dir",
        _os.path.join(_os.path.dirname(_os.path.dirname(
            _os.path.abspath(__file__))), ".jax_cache"))
    _jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

from .config import Settings, ComputeOptions, PanelFiles  # noqa: E402
from .models.dist import dist, distmix  # noqa: E402
from .models.ld import compute_ld, simulate_ld  # noqa: E402

# reference-style aliases
computeLD = compute_ld
simulateLD = simulate_ld

__version__ = "0.1.0"

__all__ = [
    "Settings", "ComputeOptions", "PanelFiles",
    "dist", "distmix",
    "compute_ld", "simulate_ld", "computeLD", "simulateLD",
]


def __getattr__(name):
    """Lazy exports for the wider API surface (keeps import light)."""
    lazy = {
        "afmix": ("gauss_jax.models.ancestry", "afmix"),
        "cpw2": ("gauss_jax.models.ancestry", "cpw2"),
        "zmix": ("gauss_jax.models.ancestry", "zmix"),
        "prep_zmix": ("gauss_jax.models.ancestry", "prep_zmix"),
        "prep_zmix2": ("gauss_jax.models.ancestry", "prep_zmix2"),
        "prep_zmix3": ("gauss_jax.models.ancestry", "prep_zmix3"),
        "prep_zmix4": ("gauss_jax.models.ancestry", "prep_zmix4"),
        "prep_zmix5": ("gauss_jax.models.ancestry", "prep_zmix5"),
        "prep_zmix5_sup": ("gauss_jax.models.ancestry", "prep_zmix5_sup"),
        "qcat": ("gauss_jax.models.qcat", "qcat"),
        "qcatmix": ("gauss_jax.models.qcat", "qcatmix"),
        "prep_qcat": ("gauss_jax.models.qcat", "prep_qcat"),
        "prep_recessive_impute": ("gauss_jax.models.qcat", "prep_recessive_impute"),
        "jepeg": ("gauss_jax.models.jepeg", "jepeg"),
        "jepegmix": ("gauss_jax.models.jepeg", "jepegmix"),
        "fiqt": ("gauss_jax.models.fiqt", "fiqt"),
        "PGC2_SCZ_ANC_Prop": ("gauss_jax.data", "PGC2_SCZ_ANC_Prop"),
        "pgc2_scz_anc_prop": ("gauss_jax.data", "pgc2_scz_anc_prop"),
    }
    if name in lazy:
        import importlib
        mod, attr = lazy[name]
        return getattr(importlib.import_module(mod), attr)
    raise AttributeError(f"module 'gauss_jax' has no attribute '{name}'")
