"""Framework configuration (typed; SURVEY.md §5 "config/flag system").

The reference has no runtime config (message length is the only parameter,
src/lib.rs:138); this build adds a small typed config: compilation cache,
artifact cache directory, mesh axis name.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from pathlib import Path

# the checkout root: caches live inside it (listed in .gitignore)
REPO_ROOT = Path(__file__).resolve().parents[2]

_DEF_CACHE = os.environ.get("ZKAES_CACHE_DIR",
                            str(REPO_ROOT / ".cache" / "zkaes"))


@dataclass
class Config:
    # directory for compiled circuit templates, SRS checkpoints, jax cache
    cache_dir: str = _DEF_CACHE
    # default hiding (the reference proves in zero-knowledge)
    zk: bool = True
    # mesh axis name used by parallel/ modules
    mesh_axis: str = "shard"

    @property
    def template_dir(self) -> Path:
        p = Path(self.cache_dir) / "templates"
        p.mkdir(parents=True, exist_ok=True)
        return p

    @property
    def srs_dir(self) -> Path:
        p = Path(self.cache_dir) / "srs"
        p.mkdir(parents=True, exist_ok=True)
        return p


CONFIG = Config()


_jax_cache_initialized = False


def init_jax_compilation_cache() -> None:
    """Persist XLA compilations across processes — limb-arithmetic programs
    are large and re-used identically every run.

    JAX_COMPILATION_CACHE_DIR, when set, names the cache and JAX reads it
    itself. Otherwise the cache is <checkout>/.jax_cache/host_<fp>: a fixed
    path (the path is part of the cache key) keyed by a host fingerprint,
    because XLA:CPU caches AOT machine code for the exact CPU feature set
    and a cache from another machine can load binaries that compute wrong
    results or fault."""
    global _jax_cache_initialized
    if _jax_cache_initialized:
        return
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir",
                          str(default_jax_cache_dir()))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    _jax_cache_initialized = True


def default_jax_cache_dir() -> Path:
    """The compile cache's directory when JAX_COMPILATION_CACHE_DIR is
    unset."""
    import hashlib
    import platform

    import jax

    fp_src = "|".join([
        platform.machine(),
        platform.processor() or "",
        _cpu_flags_fingerprint(),
        jax.__version__,
    ])
    fp = hashlib.blake2s(fp_src.encode()).hexdigest()[:12]
    return REPO_ROOT / ".jax_cache" / f"host_{fp}"


def _cpu_flags_fingerprint() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    return ",".join(sorted(line.split(":", 1)[1].split()))
    except OSError:
        pass
    return "unknown"
