"""Race-detection CI: run the -t thread pool under ThreadSanitizer.

Builds the native library with -fsanitize=thread (a separate artifact,
so the production lib is untouched) and drives a multi-threaded
alignment through the CLI with libtsan preloaded. Any data race in the
finalize pool (native/pipeline.cpp's -t path) prints a
"WARNING: ThreadSanitizer" report and flips the exit code via
halt_on_error. The reference's analogue is its pthread pool
(Mapping.cpp:591-664), which has no sanitizer job at all."""

import glob
import os
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def _libtsan():
    for pat in ("/usr/lib/gcc/x86_64-linux-gnu/*/libtsan.so",
                "/usr/lib/x86_64-linux-gnu/libtsan.so.*"):
        hits = sorted(glob.glob(pat))
        if hits:
            return hits[0]
    return None


def test_thread_pool_race_free(tmp_path):
    libtsan = _libtsan()
    if libtsan is None:
        pytest.skip("libtsan not available")
    env = dict(os.environ)
    env["DART_TPU_TSAN"] = "1"
    env["LD_PRELOAD"] = libtsan
    env["TSAN_OPTIONS"] = "halt_on_error=1 exitcode=66"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONMALLOC"] = "malloc"  # pymalloc confuses tsan interceptors
    out = tmp_path / "out.sam"
    cmd = [sys.executable, "-m", "dart_tpu.cli",
           "-i", os.path.join(HERE, "golden", "index", "toy"),
           "-f", os.path.join(HERE, "data", "spliced.fa"),
           "-t", "4", "--engine", "numpy",
           "-o", str(out), "-j", str(tmp_path / "j.tab"), "-silent"]
    p = subprocess.run(cmd, env=env, capture_output=True, timeout=600)
    err = p.stderr.decode(errors="replace")
    assert "WARNING: ThreadSanitizer" not in err, err[-4000:]
    assert p.returncode == 0, err[-4000:]
    # the run must actually have aligned (sanity that TSAN didn't
    # silently disable the native path)
    assert sum(1 for l in open(out) if not l.startswith("@")) == 600
