"""Entry points that must refuse a machine without a GPU, and the
compile-cache location every entry point shares."""
import os
import shutil
import subprocess
import sys

import jax
import pytest

from tfhe_tpu import config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_cpu_only(script, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_refuses_cpu_only_jax(where, tmp_path):
    """chip_smoke.py exits non-zero with no "ok" line on a CPU-only JAX,
    from the checkout and from a directory holding only the script."""
    script = os.path.join(ROOT, "chip_smoke.py")
    cwd = ROOT
    if where == "alone":
        script = shutil.copy(script, tmp_path / "chip_smoke.py")
        cwd = tmp_path
    r = _run_cpu_only(str(script), cwd)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "needs an NVIDIA GPU" in r.stderr


def test_bench_refuses_cpu_only_jax():
    r = _run_cpu_only(os.path.join(ROOT, "bench.py"), ROOT)
    assert r.returncode != 0
    assert '"value"' not in r.stdout


@pytest.mark.parametrize("env_dir", [None, "custom_cache"])
def test_compile_cache_dir(env_dir, tmp_path, monkeypatch):
    if env_dir is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        want = os.path.join(ROOT, ".jax_cache")
    else:
        want = str(tmp_path / env_dir)
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", want)
    assert config.compile_cache_dir() == want
    before = jax.config.jax_compilation_cache_dir
    try:
        assert config.enable_compile_cache() == want
        assert jax.config.jax_compilation_cache_dir == want
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
