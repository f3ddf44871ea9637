"""Where compiled programs are cached: JAX_COMPILATION_CACHE_DIR when set,
else one fixed directory inside the checkout."""

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

_PROBE = """
import jax
jax.config.update("jax_platforms", "cpu")
from aes_zero_knowledge_proof_circuit_tpu.ops import field_f32  # noqa
from aes_zero_knowledge_proof_circuit_tpu.utils import config
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
jax.jit(lambda x: x * 3 + 1)(jax.numpy.arange(7.0)).block_until_ready()
print(jax.config.jax_compilation_cache_dir)
print(config.default_jax_cache_dir())
"""


def _probe(env_extra):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(env_extra)
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return out.stdout.split()


def test_env_cache_dir_is_honoured(tmp_path):
    used, _default = _probe({"JAX_COMPILATION_CACHE_DIR": str(tmp_path)})
    assert Path(used) == tmp_path
    assert any(tmp_path.iterdir()), "no compiled program was cached"


def test_default_cache_dir_is_fixed_inside_checkout():
    used, default = _probe({})
    used_again, _ = _probe({})
    assert used == default == used_again
    path = Path(used)
    assert path.parent == ROOT / ".jax_cache"
    assert path.is_dir() and any(path.iterdir())
