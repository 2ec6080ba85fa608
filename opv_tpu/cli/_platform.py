"""Platform and compile-cache setup shared by the CLIs, bench.py and
chip_smoke.py.

The CLIs default to the CPU: the reference-parity paths run float64 DSP in
a serial tracking loop that gains nothing from an accelerator, and a JAX
process that opens the GPU reserves most of its memory, so only the
process that serves the card should take it (scripts/opv-pluto.sh).
`--device gpu` selects the card; a platform with no device is an error.
Must be called before any jax computation.
"""

from __future__ import annotations

import os
import pathlib

#: the persistent compile cache when JAX_COMPILATION_CACHE_DIR is unset: one
#: fixed directory in the checkout (listed in .gitignore), so every process
#: and every run of a checkout finds what the others compiled
CACHE_DIR = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"

#: --device names -> jax_platforms values.  JAX's own "gpu" alias expands to
#: "cuda,rocm", and an explicit platform list fails if any member does.
_PLATFORMS = {"gpu": "cuda"}


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compile cache and return its directory.
    JAX reads JAX_COMPILATION_CACHE_DIR itself; only without it is the
    in-checkout directory configured."""
    import jax
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(CACHE_DIR))
    return str(CACHE_DIR)


def setup_platform(device: str = "cpu", x64: bool = True) -> None:
    import jax
    if device:
        jax.config.update("jax_platforms", _PLATFORMS.get(device, device))
    if x64:
        jax.config.update("jax_enable_x64", True)
    enable_compile_cache()
    if device:
        try:
            jax.devices()
        except (RuntimeError, AssertionError) as e:
            detail = f": {e}" if str(e) else ""
            raise SystemExit(f"no {device} device available{detail}") from e
