"""utils/cache.enable_compile_cache: JAX_COMPILATION_CACHE_DIR wins and
nothing is set in code; otherwise the fixed <checkout>/.jax_cache."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent

SCRIPT = """
import jax
from rag_challenge_2_tpu.utils.cache import enable_compile_cache
print(enable_compile_cache())
print(jax.config.jax_compilation_cache_dir)
"""


@pytest.mark.parametrize("env_dir", [True, False])
def test_compile_cache_location(tmp_path, env_dir):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO))
    if env_dir:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / "xla")
    out = subprocess.run([sys.executable, "-c", SCRIPT], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    returned, configured = out.stdout.split()
    want = str(tmp_path / "xla") if env_dir else str(REPO / ".jax_cache")
    assert returned == configured == want
