"""The persistent compilation cache lives at one fixed path:
JAX_COMPILATION_CACHE_DIR when set, else .jax_cache/ at the checkout
root — never a temporary name, a process id or the time."""

import os
import subprocess
import sys

import jax
import pytest

from rsoderh_raytracing_tpu.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def restore_config():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_env_var_wins(monkeypatch, tmp_path, restore_config):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == str(tmp_path)


def test_default_is_checkout_root(monkeypatch, restore_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.enable_compile_cache()
    assert path == os.path.join(REPO, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path


def test_path_is_stable_across_processes():
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["PYTHONPATH"] = REPO
    code = ("from rsoderh_raytracing_tpu.utils.compile_cache import"
            " cache_dir; print(cache_dir())")
    paths = {
        subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                       capture_output=True, text=True, check=True,
                       timeout=120).stdout.strip()
        for cwd in (REPO, os.path.join(REPO, "tests"))
    }
    assert paths == {os.path.join(REPO, ".jax_cache")}
