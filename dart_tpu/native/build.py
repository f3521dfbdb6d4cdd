"""Lazy build + load of the dart_tpu native library (C++, via g++).

The native library hosts the host-side hot paths that the reference
implements in C/C++ (suffix-array construction for the index builder,
the chunk pipeline, read packing, BAM encoding). It is compiled into
the package directory on first use. The artifact is keyed by a hash of
the sources, the compiler flags and the host CPU (the build uses
-march=native): any mismatch rebuilds it, so only the sources beside
this file decide what runs, wherever the tree was copied from.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import sys
import sysconfig
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
_LOCK = threading.Lock()
_LIB = None

SOURCES = ["sais.cpp", "zoo.cpp", "pipeline.cpp", "pack.cpp", "bamenc.cpp",
           "layout.cpp"]


def _tsan() -> bool:
    return os.environ.get("DART_TPU_TSAN") == "1"


def _lib_path() -> str:
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    name = "libdart_native_tsan" if _tsan() else "libdart_native"
    return os.path.join(_HERE, name + suffix)


def _flags() -> list[str]:
    flags = ["-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
             "-pthread"]
    if _tsan():
        # thread-sanitized build (separate artifact name, so the
        # production lib is untouched) for auditing the -t pool;
        # exercised by tests/test_tsan.py
        flags[:0] = ["-fsanitize=thread", "-g", "-O1"]
    return flags


def host_key() -> str:
    """What -march=native compiles for: the machine and its CPU model
    and feature flags."""
    cpu = ""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("model name", "flags")):
                    cpu += line
                    if line.startswith("flags"):
                        break
    except OSError:
        pass
    return f"{platform.machine()}\n{cpu}"


def build_key() -> str:
    """Hash of the sources, the compiler flags and the host CPU."""
    h = hashlib.sha256()
    for src in SOURCES:
        h.update(src.encode() + b"\0")
        with open(os.path.join(_HERE, src), "rb") as f:
            h.update(f.read())
    h.update(" ".join(_flags()).encode() + b"\0")
    h.update(host_key().encode())
    return h.hexdigest()


def _needs_build(lib: str, key: str) -> bool:
    try:
        with open(lib + ".key") as f:
            return f.read() != key or not os.path.exists(lib)
    except OSError:
        return True


def build(force: bool = False) -> str:
    lib = _lib_path()
    with _LOCK:
        key = build_key()
        if force or _needs_build(lib, key):
            srcs = [os.path.join(_HERE, s) for s in SOURCES]
            cmd = ["g++", *_flags(), *srcs, "-o", lib + ".tmp"]
            subprocess.run(cmd, check=True, capture_output=True)
            os.replace(lib + ".tmp", lib)
            with open(lib + ".key.tmp", "w") as f:
                f.write(key)
            os.replace(lib + ".key.tmp", lib + ".key")
    return lib


def load() -> ctypes.CDLL | None:
    """Load (building if needed). Returns None, with a warning on
    stderr, if the library cannot be built or loaded."""
    global _LIB
    if _LIB is not None:
        return _LIB
    try:
        _LIB = ctypes.CDLL(build())
    except (OSError, subprocess.CalledProcessError) as e:
        detail = getattr(e, "stderr", b"") or b""
        print(f"warning: native library unavailable ({e}); using the "
              f"pure-Python pipeline. {detail.decode(errors='replace')[-500:]}",
              file=sys.stderr)
        return None
    return _LIB
