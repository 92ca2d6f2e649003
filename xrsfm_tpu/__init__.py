"""xrsfm_tpu — an incremental Structure-from-Motion framework in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of openxrlab/xrsfm
(reference layout documented in SURVEY.md): SIFT feature extraction, pairwise
descriptor matching with covisibility-based match expansion, RANSAC two-view
geometry, incremental mapping (P3P registration, multi-view triangulation,
track processing), and a from-scratch Levenberg-Marquardt bundle adjuster with
Schur-complement reduction replacing Ceres — all batched as fixed-shape
device kernels, with multi-device scale-out expressed via jax.sharding
meshes.
"""

__version__ = "0.1.0"


def enable_compilation_cache():
    """Enable JAX's persistent compilation cache, so that a shape compiled
    once (SIFT pyramid, BA step, ...) is loaded by later processes.

    Where JAX_COMPILATION_CACHE_DIR is set, JAX already keeps the cache
    there and no directory is set here; otherwise the cache is
    ``<checkout>/.jax_cache``, a fixed path (the path is part of the
    cache key)."""
    import os

    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        jax.config.update("jax_compilation_cache_dir",
                          os.path.join(root, ".jax_cache"))
    # persist every compile: a mapper run issues hundreds of small ones
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
