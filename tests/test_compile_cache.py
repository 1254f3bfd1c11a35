"""The persistent compile cache: the environment's choice, else the checkout's."""

from pathlib import Path

import jax

import gradus_tpu
from gradus_tpu.compile_cache import compile_cache_dir, enable_compile_cache

CHECKOUT_CACHE = Path(gradus_tpu.__file__).resolve().parent.parent / ".jax_cache"


def test_env_dir_wins_and_nothing_is_set(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    calls = []
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    assert compile_cache_dir() == str(tmp_path)
    assert enable_compile_cache() == str(tmp_path)
    assert calls == []


def test_checkout_dir_whatever_the_cwd(monkeypatch, tmp_path):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.chdir(tmp_path)
    calls = []
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    assert Path(compile_cache_dir()) == CHECKOUT_CACHE
    enable_compile_cache(min_compile_time_secs=2.0)
    assert calls == [
        ("jax_compilation_cache_dir", str(CHECKOUT_CACHE)),
        ("jax_persistent_cache_min_compile_time_secs", 2.0),
    ]
