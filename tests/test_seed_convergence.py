"""Worst-case seed-scan convergence: a fully repetitive read (telomeric
TTAGGG repeat) against a repetitive genome makes every seed attempt
extend to the read end and then be rejected by max_dup, so the scan
restarts at every position and costs (L+1)(L+2)/2 automaton steps —
the closed-form worst case the rerun cap must cover. The reference's
host scan has no cap (bwt_search.cpp:139-182 runs unbounded), so an
undersized cap is a parity break: seed_finish would raise
'seed scan failed to converge' on real telomeric/satellite data.

Regression for an earlier rerun cap of Lp*Lp//2, below the worst
case whenever rlen == Lp, any multiple of 32.
"""

import numpy as np
import pytest

from dart_tpu.index import builder, load_index


@pytest.fixture(scope="module")
def repeat_index(tmp_path_factory):
    d = tmp_path_factory.mktemp("repidx")
    fa = d / "rep.fa"
    seq = ("TTAGGG" * 10000)[:30000]
    fa.write_text(">telo\n" + "\n".join(seq[i:i + 70] for i in range(0, len(seq), 70)) + "\n")
    prefix = str(d / "rep")
    builder.build_index(str(fa), prefix)
    return load_index(prefix)


# TTAGGG in 2-bit codes (A=0 C=1 G=2 T=3)
_TELO = np.array([3, 3, 0, 2, 2, 2], dtype=np.uint8)


def _telo_reads(L):
    codes = np.tile(_TELO, L // 6 + 1)[:L][None, :].copy()
    return codes, np.full(1, L, dtype=np.int32)


@pytest.mark.parametrize("L", [96, 128])
def test_narrow_engine_converges_on_repeat_read(repeat_index, L):
    from dart_tpu.ops.fm_jax import FMIndexJax

    eng = FMIndexJax(repeat_index, max_dup_num=100, lut_k=0)
    codes, rlens = _telo_reads(L)
    n, rp, ln, k0, fr = eng.seed_reads(codes, rlens)
    # every seed rejected by max_dup: no accepted seeds, but the scan
    # must complete rather than raise
    assert n[0] == 0


def test_wide_engine_converges_on_repeat_read(repeat_index):
    from dart_tpu.ops.fm_jax_wide import FMIndexJaxWide

    eng = FMIndexJaxWide(repeat_index, max_dup_num=100)
    codes, rlens = _telo_reads(96)
    n, rp, ln, k0, fr = eng.seed_reads(codes, rlens)
    assert n[0] == 0
