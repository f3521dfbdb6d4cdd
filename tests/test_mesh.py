"""Multi-chip mesh tests on the virtual CPU device grid (8 devices via
conftest): the GSPMD data/index-sharded engine must be bit-equal to the
single-device engine."""

import numpy as np
import pytest


def _cpu_devices():
    import jax

    return jax.devices("cpu")


def _sample(idx, R, L, seed):
    rng = np.random.default_rng(seed)
    codes = np.empty((R, L), dtype=np.uint8)
    for i in range(R):
        p = int(rng.integers(0, idx.genome_size - L))
        codes[i] = idx.ref_codes[p:p + L]
    m = rng.random((R, L)) < 0.03
    codes = np.where(m, rng.integers(0, 5, (R, L)).astype(np.uint8), codes)
    return codes, np.full(R, L, dtype=np.int32)


@pytest.mark.parametrize("index_shards", [1, 2])
def test_sharded_engine_matches_single(toy_index, index_shards):
    """Full automaton + locate over a (data, index) mesh == plain
    single-device engine, for both replicated and sharded tables."""
    from jax.sharding import Mesh

    from dart_tpu.ops.fm_jax import FMIndexJax
    from dart_tpu.parallel.mesh import ShardedFMIndex, make_mesh

    cpus = _cpu_devices()
    if len(cpus) < 2 * index_shards:
        pytest.skip("needs a multi-device CPU mesh")
    mesh = make_mesh(min(4, len(cpus)) if index_shards == 1 else 4,
                     index_shards=index_shards, backend="cpu")
    sharded = ShardedFMIndex(toy_index, mesh)
    single = FMIndexJax(toy_index, max_dup_num=100, lut_k=0)
    codes, rlens = _sample(toy_index, 24, 96, seed=41)
    got = sharded.seed_reads(codes, rlens)
    want = single.seed_reads(codes, rlens)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(2)
    rows = rng.integers(1, toy_index.seq_len, 300, dtype=np.int64)
    np.testing.assert_array_equal(sharded.locate(rows),
                                  single.locate(rows))


def test_sharded_engine_lut_matches(toy_index):
    """The K-mer LUT init path must survive index sharding too."""
    from dart_tpu.parallel.mesh import ShardedFMIndex, make_mesh

    cpus = _cpu_devices()
    if len(cpus) < 4:
        pytest.skip("needs a multi-device CPU mesh")
    mesh = make_mesh(4, index_shards=2, backend="cpu")
    with_lut = ShardedFMIndex(toy_index, mesh, lut_k=4)
    plain = ShardedFMIndex(toy_index, mesh, lut_k=0)
    codes, rlens = _sample(toy_index, 16, 80, seed=43)
    a = with_lut.seed_reads(codes, rlens)
    b = plain.seed_reads(codes, rlens)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_cli_mesh_flag_matches_golden(tmp_path):
    """--mesh data=2,index=2 through the CLI must reproduce the golden
    output on the virtual device grid."""
    import os
    import subprocess
    import sys

    here = os.path.dirname(os.path.abspath(__file__))
    repo = os.path.dirname(here)
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    out = tmp_path / "out.sam"
    p = subprocess.run(
        [sys.executable, "-m", "dart_tpu.cli",
         "-i", os.path.join(here, "golden", "index", "toy"),
         "-f", os.path.join(here, "data", "spliced.fa"),
         "--mesh", "data=2,index=2",
         "-o", str(out), "-j", str(tmp_path / "j.tab"), "-silent"],
        env=env, capture_output=True, timeout=500)
    assert p.returncode == 0, p.stderr.decode()[-2000:]
    assert out.read_text() == open(
        os.path.join(here, "golden", "c3_spliced.sam")).read()


@pytest.mark.parametrize("n_devices,index_shards", [(16, 1), (16, 2), (4, 3)])
def test_make_mesh_refuses_what_the_backend_lacks(n_devices, index_shards):
    """More devices than the backend has (or a shard count that does not
    divide them) is an error: a mesh never borrows another backend's
    devices."""
    from dart_tpu.parallel.mesh import make_mesh

    assert len(_cpu_devices()) < 16
    with pytest.raises(ValueError):
        make_mesh(n_devices, index_shards=index_shards)
    with pytest.raises(ValueError):
        make_mesh(n_devices, index_shards=index_shards, backend="cpu")
