"""Wide (64-bit) device engine tests: the uint32-pair FM automaton and
locate kernel (ops/fm_jax_wide.py) against the NumPy oracle.

The always-on tests run on the toy index (the kernels are width-blind:
the same pair arithmetic serves small and huge genomes). The genuine
cross-2^31 boundary test — build a >1.07 Gbp synthetic genome so
fwd+RC exceeds 2^31 text positions, then seed and locate across the
boundary — is gated behind DART_TPU_BIG=1 (it needs ~40 GB RAM and
minutes of SA-IS); tools/run_big_wide_check.py drives it.
Reference equivalent: the int64 index/search types in
/root/reference/src/structure.h:29-45 and bwt_search.cpp:127-182.
"""

import numpy as np
import pytest

from dart_tpu.ops.fm_numpy import FMIndexNumpy


@pytest.fixture(scope="module")
def wide(toy_index):
    from dart_tpu.ops.fm_jax_wide import FMIndexJaxWide

    return FMIndexJaxWide(toy_index, max_dup_num=100)


@pytest.fixture(scope="module")
def fm(toy_index):
    return FMIndexNumpy(toy_index)


def test_pair_arithmetic_vs_int64():
    """Property-check the (lo, hi) uint32 pair ops against numpy int64
    across carry/borrow boundaries."""
    import jax

    from dart_tpu.ops import fm_jax_wide as w

    rng = np.random.default_rng(5)
    interesting = np.array(
        [0, 1, 2**31 - 1, 2**31, 2**32 - 1, 2**32, 2**32 + 1,
         2**40, 2**62, (1 << 63) - 1], dtype=np.uint64)
    a = np.concatenate([interesting,
                        rng.integers(0, 1 << 63, 200, dtype=np.uint64)])
    b = np.concatenate([interesting[::-1],
                        rng.integers(0, 1 << 63, 200, dtype=np.uint64)])
    alo, ahi = w._split64(a.view(np.int64))
    blo, bhi = w._split64(b.view(np.int64))

    @jax.jit
    def run(alo, ahi, blo, bhi):
        s = w._p_add(alo, ahi, blo, bhi)
        d = w._p_sub(alo, ahi, blo, bhi)
        lt = w._p_lt(alo, ahi, blo, bhi)
        le = w._p_le(alo, ahi, blo, bhi)
        sh = w._p_shr(alo, ahi, 7)
        i32 = (blo & 0x7FFFFFFF).astype(np.int32) - (bhi & 1).astype(np.int32)
        ai = w._p_add_i32(alo, ahi, i32)
        return s, d, lt, le, sh, ai, i32

    out = run(alo, ahi, blo, bhi)
    s = w._join64(*map(np.asarray, out[0])).view(np.uint64)
    d = w._join64(*map(np.asarray, out[1])).view(np.uint64)
    lt = np.asarray(out[2])
    le = np.asarray(out[3])
    sh = w._join64(*map(np.asarray, out[4])).view(np.uint64)
    ai = w._join64(*map(np.asarray, out[5])).view(np.uint64)
    i32 = np.asarray(out[6])
    np.testing.assert_array_equal(s, a + b)
    np.testing.assert_array_equal(d, a - b)
    np.testing.assert_array_equal(lt, a < b)
    np.testing.assert_array_equal(le, a <= b)
    np.testing.assert_array_equal(sh, a >> 7)
    np.testing.assert_array_equal(
        ai, (a.astype(np.int64) + i32).view(np.uint64))


def _sample_reads(idx, R, L, seed, mut=0.03):
    rng = np.random.default_rng(seed)
    codes = np.empty((R, L), dtype=np.uint8)
    for i in range(R):
        p = int(rng.integers(0, idx.genome_size - L))
        codes[i] = idx.ref_codes[p:p + L]
    m = rng.random((R, L)) < mut
    codes = np.where(m, rng.integers(0, 5, (R, L)).astype(np.uint8), codes)
    return codes, np.full(R, L, dtype=np.int32)


def _assert_seed_tables_match(fm, got, want, R):
    """Engine seed tables vs the all-walks oracle, normalizing direct
    fast-extension seeds (freq == -1, k0 slot holds the genome
    position): such a seed must correspond to an oracle seed with
    exactly one occurrence at that position."""
    n_w, rp_w, ln_w, k0_w, fr_w = got
    n_o, rp_o, ln_o, k0_o, fr_o = want
    np.testing.assert_array_equal(n_w, n_o)
    for r in range(R):
        k = int(n_o[r])
        np.testing.assert_array_equal(rp_w[r, :k], rp_o[r, :k])
        np.testing.assert_array_equal(ln_w[r, :k], ln_o[r, :k])
        np.testing.assert_array_equal(fr_w[r, :k],
                                      np.where(fr_w[r, :k] < 0, -1,
                                               fr_o[r, :k]))
        for s in range(k):
            if fr_w[r, s] < 0:
                assert fr_o[r, s] == 1
                assert k0_w[r, s] == int(
                    fm.locate(np.array([k0_o[r, s]], dtype=np.int64))[0])
            else:
                assert k0_w[r, s] == k0_o[r, s]


def test_wide_seed_scan_matches_oracle(toy_index, wide, fm):
    """The wide automaton's seed tables must equal the all-walks oracle
    replay (direct fast-extension seeds normalized)."""
    from dart_tpu.aligner import _NumpyEngine
    from dart_tpu.pipeline.seeding import seed_reads_from_all_walks

    codes, rlens = _sample_reads(toy_index, 48, 100, seed=21)
    # mix in short/odd lengths and an all-N read
    rlens[:6] = [17, 30, 16, 15, 99, 64]
    codes[3] = 4
    got = wide.seed_reads(codes, rlens)
    eng = _NumpyEngine(fm, 100)
    want = seed_reads_from_all_walks(eng, codes, rlens, 100)
    _assert_seed_tables_match(fm, got, want, len(rlens))
    assert (got[4] < 0).any(), "fast-extension path never engaged"


def test_wide_seed_scan_lut_matches_oracle(toy_index, fm):
    """LUT-initialized wide scans must match the oracle too (and the
    LUT-off engine's tables, direct seeds and all)."""
    from dart_tpu.aligner import _NumpyEngine
    from dart_tpu.ops.fm_jax_wide import FMIndexJaxWide
    from dart_tpu.pipeline.seeding import seed_reads_from_all_walks

    lut_eng = FMIndexJaxWide(toy_index, max_dup_num=100, lut_k=4)
    codes, rlens = _sample_reads(toy_index, 32, 100, seed=27)
    rlens[:3] = [17, 31, 64]
    codes[5, 40:44] = 4
    got = lut_eng.seed_reads(codes, rlens)
    eng = _NumpyEngine(fm, 100)
    want = seed_reads_from_all_walks(eng, codes, rlens, 100)
    _assert_seed_tables_match(fm, got, want, len(rlens))


def test_wide_locate_matches_oracle(toy_index, wide, fm):
    rng = np.random.default_rng(9)
    rows = rng.integers(1, toy_index.seq_len, 500, dtype=np.int64)
    got = wide.locate(rows)
    want = fm.locate(rows)
    np.testing.assert_array_equal(got, want)


def test_wide_sharded_index_matches(toy_index, fm):
    """index-mesh sharding (GSPMD-partitioned block/SA tables) must not
    change any result."""
    import jax
    from jax.sharding import Mesh

    from dart_tpu.ops.fm_jax_wide import FMIndexJaxWide

    cpus = jax.devices("cpu")
    if len(cpus) < 2:
        pytest.skip("needs multi-device CPU mesh")
    mesh = Mesh(np.array(cpus[:2]), ("index",))
    wide = FMIndexJaxWide(toy_index, max_dup_num=100, index_mesh=mesh)
    codes, rlens = _sample_reads(toy_index, 16, 80, seed=33)
    got = wide.seed_reads(codes, rlens)
    from dart_tpu.aligner import _NumpyEngine
    from dart_tpu.pipeline.seeding import seed_reads_from_all_walks

    want = seed_reads_from_all_walks(
        _NumpyEngine(fm, 100), codes, rlens, 100)
    _assert_seed_tables_match(fm, got, want, 16)
    rng = np.random.default_rng(3)
    rows = rng.integers(1, toy_index.seq_len, 200, dtype=np.int64)
    np.testing.assert_array_equal(wide.locate(rows), fm.locate(rows))


def test_wide_data_index_mesh_matches(toy_index, fm):
    """The full ("data", "index") mesh — read lanes data-sharded AND
    the table index-sharded — must not change any result (the flagship
    multi-chip GRCh38 shape: make_engine builds this mesh for --mesh
    data=N,index=M on a wide-genome index)."""
    import jax

    from dart_tpu.ops.fm_jax_wide import FMIndexJaxWide
    from dart_tpu.parallel.mesh import make_mesh

    if len(jax.devices("cpu")) < 4:
        pytest.skip("needs a 4-device CPU mesh")
    mesh = make_mesh(4, index_shards=2, backend="cpu")
    wide = FMIndexJaxWide(toy_index, max_dup_num=100, index_mesh=mesh,
                          lut_k=4)
    codes, rlens = _sample_reads(toy_index, 24, 96, seed=41)
    rlens[:2] = [17, 33]
    codes[7, 50:53] = 4
    got = wide.seed_reads(codes, rlens)
    from dart_tpu.aligner import _NumpyEngine
    from dart_tpu.pipeline.seeding import seed_reads_from_all_walks

    want = seed_reads_from_all_walks(
        _NumpyEngine(fm, 100), codes, rlens, 100)
    _assert_seed_tables_match(fm, got, want, 24)
    rng = np.random.default_rng(8)
    rows = rng.integers(1, toy_index.seq_len, 300, dtype=np.int64)
    np.testing.assert_array_equal(wide.locate(rows), fm.locate(rows))


@pytest.mark.gpu
def test_wide_engine_on_gpu(gpu, toy_index, fm):
    """The wide engine with its tables on the GPU (LUT init on, as the
    aligner runs it there): seed tables and locates bit-equal to the
    NumPy oracle."""
    from dart_tpu.aligner import _NumpyEngine
    from dart_tpu.ops.fm_jax_wide import FMIndexJaxWide
    from dart_tpu.pipeline.seeding import seed_reads_from_all_walks

    wide = FMIndexJaxWide(toy_index, max_dup_num=100, lut_k=4)
    assert {d.platform for d in wide.blocks.devices()} == {"gpu"}
    codes, rlens = _sample_reads(toy_index, 64, 100, seed=29)
    rlens[:4] = [17, 30, 64, 99]
    codes[9, 20:23] = 4
    got = wide.seed_reads(codes, rlens)
    want = seed_reads_from_all_walks(_NumpyEngine(fm, 100), codes, rlens, 100)
    _assert_seed_tables_match(fm, got, want, len(rlens))
    rows = np.random.default_rng(13).integers(1, toy_index.seq_len, 500,
                                              dtype=np.int64)
    np.testing.assert_array_equal(wide.locate(rows), fm.locate(rows))


def test_lean_numpy_occ_matches_full(toy_index):
    """The checkpoint-based lean occ mode (the >2^31 oracle) must equal
    the full-table mode."""
    full = FMIndexNumpy(toy_index, lean=False)
    lean = FMIndexNumpy(toy_index, lean=True)
    rng = np.random.default_rng(17)
    k = np.concatenate([
        np.array([-1, 0, 1, toy_index.primary - 1, toy_index.primary,
                  toy_index.primary + 1, toy_index.seq_len - 1],
                 dtype=np.int64),
        rng.integers(-1, toy_index.seq_len, 300, dtype=np.int64)])
    np.testing.assert_array_equal(full.occ4(k), lean.occ4(k))


@pytest.mark.skipif("DART_TPU_BIG" not in __import__("os").environ,
                    reason="multi-hour SA-IS build; set DART_TPU_BIG=1")
def test_big_genome_cross_2e31(tmp_path):
    """The genuine >2^31 boundary check: build a 1.1 Gbp genome
    (fwd+RC text > 2^31), then seed and locate across the boundary,
    bit-equal to the lean oracle, by running
    tools/run_big_wide_check.py."""
    import subprocess
    import sys

    repo = __import__("os").path.dirname(
        __import__("os").path.dirname(__import__("os").path.abspath(__file__)))
    p = subprocess.run(
        [sys.executable, "tools/run_big_wide_check.py", "--gbp", "1.1"],
        cwd=repo, capture_output=True, timeout=6 * 3600)
    assert p.returncode == 0, p.stdout.decode()[-3000:] + p.stderr.decode()[-3000:]
    assert b"ALL CHECKS PASS" in p.stdout


def test_wide_sharded_cache_repack(toy_index, tmp_path, monkeypatch, fm):
    """A sharded wide engine built on top of a warmed unsharded layout
    cache must repack (not re-derive) the table — identical rows and
    offsets to build_merged_table_wide(idx, n), and identical results.
    This is the giant-index path: at GRCh38 scale the repack reads the
    disk cache instead of re-deriving 6+ GB from the raw index."""
    import shutil

    import jax

    from dart_tpu.index import layout_cache, load_index
    from dart_tpu.ops import fm_jax_wide as w

    if len(jax.devices("cpu")) < 2:
        pytest.skip("needs a 2-device CPU mesh")
    for ext in (".bwt", ".sa", ".sad", ".pac", ".ann", ".amb"):
        src = toy_index.prefix + ext
        if __import__("os").path.exists(src):
            shutil.copy(src, str(tmp_path / ("toy" + ext)))
    monkeypatch.setattr(layout_cache, "CACHE_MIN_SEQ", 0)
    idx = load_index(str(tmp_path / "toy"))
    # 1) unsharded engine warms the wtab cache
    w.FMIndexJaxWide(idx, max_dup_num=100)
    assert (tmp_path / "toy.wtab").exists()
    # 2) sharded engine must repack from it (and cache the result)
    from jax.sharding import Mesh

    mesh = Mesh(np.array(jax.devices("cpu")[:2]), ("index",))
    sharded = w.FMIndexJaxWide(idx, max_dup_num=100, index_mesh=mesh)
    assert (tmp_path / "toy.wtab2").exists()
    want_tab, want_ref, want_sad = w.build_merged_table_wide(idx, 2)
    assert (sharded.ref_off, sharded.sad_off) == (want_ref, want_sad)
    np.testing.assert_array_equal(np.asarray(sharded.blocks), want_tab)
    # 3) results bit-equal to the oracle through the repacked table
    rng = np.random.default_rng(23)
    codes = np.empty((8, 64), np.uint8)
    for i in range(8):
        p = int(rng.integers(0, idx.seq_len - 64))
        codes[i] = idx.ref_codes[p:p + 64]
    rlens = np.full(8, 64, np.int32)
    got = sharded.seed_reads(codes, rlens)
    from dart_tpu.aligner import _NumpyEngine
    from dart_tpu.pipeline.seeding import seed_reads_from_all_walks

    want = seed_reads_from_all_walks(_NumpyEngine(fm, 100), codes, rlens, 100)
    _assert_seed_tables_match(fm, got, want, 8)
    rows = rng.integers(1, idx.seq_len, 100, dtype=np.int64)
    np.testing.assert_array_equal(sharded.locate(rows), fm.locate(rows))
