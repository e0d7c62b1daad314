"""Platform setup, the compile cache, and chip_smoke.py without a GPU."""

import os
import shutil
import subprocess
import sys

import jax
import pytest

from amf_tpu.utils import platform

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _python(code_or_args, env_update, cwd=REPO):
    env = dict(os.environ, **env_update)
    env.pop("XLA_FLAGS", None)
    args = (["-c", code_or_args] if isinstance(code_or_args, str)
            else code_or_args)
    return subprocess.run([sys.executable, *args], env=env, cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def test_setup_honours_jax_platforms():
    r = _python("import jax; from amf_tpu.utils.platform import setup; "
                "print(setup(True), jax.config.jax_enable_x64)",
                {"JAX_PLATFORMS": "cpu"})
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == ["cpu", "True"]


def test_setup_raises_for_missing_platform():
    r = _python("from amf_tpu.utils.platform import setup; setup(False)",
                {"JAX_PLATFORMS": "cuda"})
    assert r.returncode != 0
    assert "Traceback" in r.stderr  # raised, not fallen back to the CPU


def test_setup_keeps_x64_on_the_default_platform(monkeypatch):
    updates = []
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: updates.append(name))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/nonexistent")
    assert platform.setup(use_x64=True) == jax.default_backend()
    assert updates == ["jax_enable_x64"]


def test_compile_cache_env_var_wins(monkeypatch, tmp_path):
    updates = []
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: updates.append((name, value)))
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert platform.enable_compile_cache() == str(tmp_path)
    assert updates == []  # JAX reads the variable itself


def test_compile_cache_default_is_in_the_checkout(monkeypatch):
    updates = []
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: updates.append((name, value)))
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = platform.enable_compile_cache()
    assert path == os.path.join(REPO, ".jax_cache")
    assert updates == [("jax_compilation_cache_dir", path)]


def test_compile_cache_off_on_the_cpu(monkeypatch):
    updates = []
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: updates.append(name))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert platform.enable_compile_cache() is None
    assert updates == []


def test_chip_smoke_fails_without_a_gpu():
    r = _python(["chip_smoke.py"], {"JAX_PLATFORMS": "cpu"})
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_chip_smoke_fails_outside_the_repo(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _python(["chip_smoke.py"], {"JAX_PLATFORMS": "cpu"}, cwd=tmp_path)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
