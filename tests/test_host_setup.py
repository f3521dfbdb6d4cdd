"""Set-up that must not depend on the machine a tree was copied from:
the persistent compile cache's directory and the native library's
build key."""

import os
import shutil

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("env_dir", [False, True])
def test_compile_cache_dir(monkeypatch, tmp_path, env_dir):
    """JAX_COMPILATION_CACHE_DIR, when set, is JAX's to read: the
    program sets no directory. Otherwise the cache sits at one fixed
    path inside the checkout."""
    import jax

    from dart_tpu import aligner

    before = jax.config.jax_compilation_cache_dir
    try:
        jax.config.update("jax_compilation_cache_dir", None)
        if env_dir:
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        else:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        aligner._enable_compile_cache()
        got = jax.config.jax_compilation_cache_dir
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    assert aligner.CACHE_DIR == os.path.join(REPO, ".jax_cache")
    assert got == (None if env_dir else aligner.CACHE_DIR)


@pytest.mark.parametrize("change", ["source", "host", "flags"])
def test_native_rebuilds_when_its_key_changes(monkeypatch, tmp_path, change):
    """The library is keyed by its sources, flags and host CPU; a
    library built from other sources or for another CPU is rebuilt."""
    from dart_tpu.native import build

    for src in build.SOURCES:
        shutil.copy(os.path.join(build._HERE, src), tmp_path / src)
    monkeypatch.setattr(build, "_HERE", str(tmp_path))
    monkeypatch.delenv("DART_TPU_TSAN", raising=False)
    lib = str(tmp_path / "libdart_native.so")
    open(lib, "wb").close()
    key = build.build_key()
    with open(lib + ".key", "w") as f:
        f.write(key)
    assert not build._needs_build(lib, build.build_key())
    if change == "source":
        with open(tmp_path / "zoo.cpp", "a") as f:
            f.write("\n// edited\n")
    elif change == "host":
        monkeypatch.setattr(build, "host_key", lambda: "another cpu")
    else:
        monkeypatch.setenv("DART_TPU_TSAN", "1")
    assert build.build_key() != key
    assert build._needs_build(lib, build.build_key())
    os.remove(lib)
    assert build._needs_build(lib, key)
