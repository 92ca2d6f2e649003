"""Platform plumbing: compile-cache placement and the refusals that keep
GPU-only entry points from quietly running on the CPU."""

import os
import sys

import jax
import pytest

import xrsfm_tpu

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CACHE_KEYS = ("jax_compilation_cache_dir",
               "jax_persistent_cache_min_compile_time_secs",
               "jax_persistent_cache_min_entry_size_bytes")


@pytest.fixture
def restore_cache_config():
    saved = {k: getattr(jax.config, k) for k in _CACHE_KEYS}
    yield
    for k, v in saved.items():
        jax.config.update(k, v)


def test_compile_cache_in_checkout_when_env_unset(monkeypatch,
                                                   restore_cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    jax.config.update("jax_compilation_cache_dir", None)
    xrsfm_tpu.enable_compilation_cache()
    assert jax.config.jax_compilation_cache_dir == os.path.join(
        REPO, ".jax_cache")
    assert jax.config.jax_persistent_cache_min_compile_time_secs == 0.0


def test_compile_cache_honours_env(monkeypatch, restore_cache_config,
                                   tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    jax.config.update("jax_compilation_cache_dir", str(tmp_path))
    xrsfm_tpu.enable_compilation_cache()
    # no directory of its own: the one JAX took from the environment
    assert jax.config.jax_compilation_cache_dir == str(tmp_path)


def _import_root(name):
    sys.path.insert(0, REPO)
    try:
        return __import__(name)
    finally:
        sys.path.remove(REPO)


def test_chip_smoke_guard_refuses_cpu():
    chip_smoke = _import_root("chip_smoke")
    with pytest.raises(RuntimeError, match="no GPU"):
        chip_smoke.device_guard()


def test_bench_refuses_cpu():
    bench = _import_root("bench")
    with pytest.raises(SystemExit, match="needs a GPU"):
        bench.main()


def test_dryrun_multichip_needs_the_devices():
    entry = _import_root("__graft_entry__")
    with pytest.raises(RuntimeError, match="devices needed"):
        entry.dryrun_multichip(len(jax.devices()) + 1)


def test_dryrun_multichip_on_virtual_devices(capsys):
    """Cost parity and a live focal dof on a 4-device mesh of the
    default platform (virtual CPU devices here)."""
    entry = _import_root("__graft_entry__")
    entry.dryrun_multichip(4)
    out = capsys.readouterr().out
    assert "pose-only: 4 devices" in out
    assert "intrinsics-refining: 4 devices" in out
