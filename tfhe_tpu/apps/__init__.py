"""Application entry points (alice / cloud / verify / cli / linreg) — the
reference's client/cloud trust split (cpuParallel/main.cpp, cloud.cpp) and
experiment driver (gpuParallel/main.cu:2714-2798)."""


def force_cpu_backend():
    """Pin jax to the CPU backend before first use: CPU for toy params.
    Must be called before any jax computation."""
    import jax

    jax.config.update("jax_platforms", "cpu")
