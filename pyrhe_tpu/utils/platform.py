"""Backend selection helpers."""
from __future__ import annotations

import os


def ensure_platform(device: str | None = None,
                    dtype: str | None = None) -> None:
    """Honor device="cpu" (or JAX_PLATFORMS=cpu) and float64 requests
    before any arrays exist. Safe to call multiple times."""
    import jax

    want_cpu = (device == "cpu"
                or os.environ.get("JAX_PLATFORMS", "") == "cpu")
    if want_cpu and jax.default_backend() != "cpu":
        from jax.extend.backend import clear_backends
        clear_backends()
        jax.config.update("jax_platforms", "cpu")
    if dtype == "float64" and not jax.config.read("jax_enable_x64"):
        if jax.default_backend() != "cpu":
            raise ValueError("dtype=float64 requires --device cpu")
        jax.config.update("jax_enable_x64", True)
