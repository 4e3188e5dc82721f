"""Where the program keeps its compile cache, and that the chip smoke test
refuses to run anywhere but on a GPU."""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_compile_cache_dir_rule(tmp_path):
    import rnb_tpu
    assert rnb_tpu.compile_cache_dir(
        {"JAX_COMPILATION_CACHE_DIR": str(tmp_path)}) == str(tmp_path)
    assert rnb_tpu.compile_cache_dir({}) == os.path.join(ROOT, ".jax_cache")


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_dir_on_import(tmp_path, env_set):
    """With JAX_COMPILATION_CACHE_DIR set, JAX uses it and the package sets
    nothing; unset, the cache goes to the fixed, git-ignored
    <checkout>/.jax_cache."""
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    if env_set:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path)
    out = subprocess.run(
        [sys.executable, "-c", "import rnb_tpu, jax; "
         "print(jax.config.jax_compilation_cache_dir)"],
        cwd=ROOT, env=env, capture_output=True, text=True, check=True)
    want = str(tmp_path) if env_set else os.path.join(ROOT, ".jax_cache")
    assert out.stdout.strip() == want
    if not env_set:
        ignored = subprocess.run(["git", "check-ignore", "-q", want],
                                 cwd=ROOT)
        assert ignored.returncode in (0, 128)   # 128: not a git checkout


def test_chip_smoke_refuses_cpu():
    """On the CPU the smoke test exits non-zero and prints no result line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "no GPU" in out.stdout
