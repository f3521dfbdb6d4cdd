"""Cross-2^31 boundary check for the wide (64-bit) device engine.

Builds a synthetic genome big enough that the fwd+RC text exceeds 2^31
positions (>= 1.08 Gbp), indexes it with the SA-IS builder, then runs
the wide seeding automaton + locate kernel on reads sampled from BOTH
ends of the text (rows below and above 2^31) and verifies every result
bit-equal against the lean NumPy oracle.

This is the executable form of tests/test_fm_wide.py's gated big test:
  DART_TPU_BIG=1 python tools/run_big_wide_check.py [--gbp 1.1]
Reference equivalent: the int64 index types (structure.h:29-45) that
let the reference handle GRCh38 (~6.2e9 text positions) natively.

The run takes minutes (SA-IS over >2.2e9 chars) and ~40 GB RAM.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# correctness check: run on the CPU backend
os.environ["JAX_PLATFORMS"] = "cpu"

import numpy as np


def log(msg):
    print(f"[{time.strftime('%H:%M:%S')}] {msg}", flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--gbp", type=float, default=1.1,
                    help="genome size in Gbp (fwd+RC text = 2x this)")
    ap.add_argument("--workdir", default="/tmp/dart_big_wide")
    ap.add_argument("--reads", type=int, default=2048)
    args = ap.parse_args()

    os.makedirs(args.workdir, exist_ok=True)
    n = int(args.gbp * 1e9)
    fa = os.path.join(args.workdir, "big.fa")
    prefix = os.path.join(args.workdir, "big")

    if not os.path.exists(prefix + ".bwt"):
        log(f"writing synthetic genome: {n/1e9:.2f} Gbp, 4 chromosomes")
        rng = np.random.default_rng(42)
        lut = np.frombuffer(b"ACGT", dtype=np.uint8)
        with open(fa, "wb") as f:
            per = n // 4
            for c in range(4):
                f.write(b">chr%d\n" % (c + 1))
                # low-order Markov-ish structure: tile 1 kb motifs with
                # mutations so the BWT has realistic run structure
                base = rng.integers(0, 4, per, dtype=np.int8)
                seq = lut[base]
                for off in range(0, per, 1 << 24):
                    chunk = seq[off:off + (1 << 24)]
                    f.write(chunk.tobytes())
                    f.write(b"\n")
        log("building index (SA-IS over fwd+RC)...")
        t0 = time.time()
        from dart_tpu.index.builder import build_index

        build_index(fa, prefix)
        log(f"index built in {time.time()-t0:.0f} s")

    from dart_tpu.index import load_index

    log("loading index...")
    idx = load_index(prefix)
    log(f"seq_len={idx.seq_len} (2^31={2**31}); "
        f"crosses boundary: {idx.seq_len >= 2**31}")
    assert idx.seq_len >= 2**31, "genome too small to cross the boundary"

    from dart_tpu.ops.fm_jax_wide import FMIndexJaxWide
    from dart_tpu.ops.fm_numpy import FMIndexNumpy

    log("constructing engines (wide device layout + lean oracle)...")
    wide = FMIndexJaxWide(idx, max_dup_num=100)
    oracle = FMIndexNumpy(idx, lean=True)

    # ---- locate across the boundary ----
    rng = np.random.default_rng(7)
    rows = np.concatenate([
        rng.integers(1, 2**31, args.reads // 2, dtype=np.int64),
        rng.integers(2**31, idx.seq_len, args.reads // 2, dtype=np.int64)])
    log(f"locate: {rows.size} rows straddling 2^31...")
    t0 = time.time()
    got = wide.locate(rows)
    log(f"device locate done in {time.time()-t0:.0f} s; oracle...")
    want = oracle.locate(rows)
    np.testing.assert_array_equal(got, want)
    above = int((np.asarray(want) >= 2**31).sum())
    log(f"locate PASS ({above} results above 2^31)")

    # ---- seeding across the boundary ----
    L = 100
    R = args.reads
    codes = np.empty((R, L), dtype=np.uint8)
    gsz = idx.genome_size
    for i in range(R):
        # sample from the high half too (RC text -> rows above 2^31)
        p = int(rng.integers(0, gsz - L))
        codes[i] = idx.ref_codes[p:p + L]
    m = rng.random((R, L)) < 0.02
    codes = np.where(m, rng.integers(0, 5, (R, L)).astype(np.uint8), codes)
    rlens = np.full(R, L, dtype=np.int32)
    log(f"seed scan: {R} reads x {L} bp...")
    t0 = time.time()
    n_w, rp_w, ln_w, k0_w, fr_w = wide.seed_reads(codes, rlens)
    log(f"device scan done in {time.time()-t0:.0f} s; oracle replay "
        f"(subset)...")
    # oracle replay on a subset (all-walks is O(R*L) walks on host)
    sub = rng.choice(R, 64, replace=False)
    from dart_tpu.aligner import _NumpyEngine
    from dart_tpu.pipeline.seeding import seed_reads_from_all_walks

    n_o, rp_o, ln_o, k0_o, fr_o = seed_reads_from_all_walks(
        _NumpyEngine(oracle, 100), codes[sub], rlens[sub], 100)
    np.testing.assert_array_equal(n_w[sub], n_o)
    hi_rows = 0
    for j, r in enumerate(sub):
        k = int(n_o[j])
        np.testing.assert_array_equal(rp_w[r, :k], rp_o[j, :k])
        np.testing.assert_array_equal(ln_w[r, :k], ln_o[j, :k])
        np.testing.assert_array_equal(k0_w[r, :k], k0_o[j, :k])
        np.testing.assert_array_equal(fr_w[r, :k], fr_o[j, :k])
        hi_rows += int((k0_o[j, :k] >= 2**31).sum())
    log(f"seed scan PASS (64-read oracle subset; {hi_rows} seed rows "
        f"above 2^31)")
    log("ALL CHECKS PASS")


if __name__ == "__main__":
    main()
