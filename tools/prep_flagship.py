"""One-shot flagship (GRCh38-class) dataset preparation for bench.py.

Chains everything the grch38_pe_bam bench config needs, resumable at
each stage (every stage is a no-op when its artifact exists):
  1. tools/build_grch38.py  — 3.09 Gbp genome + 50k pairs + wide index
  2. bench.ensure_parity_oracle — the reference -t 1 SAM oracle
  3. tools/warm_layout_cache.py — derive the disk-backed layouts once

Stage 1's --builder choice is a history note: the flagship index on
disk was built by the reference bwt_index binary during round-4 prep
(7259 s, block-incremental BWT-SW, bwt_gen.c:1292-1595). Our SA-IS
builder was then run on the identical genome (2026-08-20,
build_grch38 --builder ours --force-index): 3409 s — 2.1x faster at
3.09 Gbp — and all five output files byte-identical to the
reference's (cmp over 5.4 GB; .sad at wide scale degenerates to the
same intv-32 sampling as .sa, builder.py:264, so the aligner loses
nothing either way). Both times are from one shared build VM, a few
hours apart; the measured pairs at
8/50 Mbp live in each dataset's meta.json build_pair_s. The earlier
"~8 h SA-IS estimate" in this docstring's round-4 version was wrong:
measured peak RSS was ~75 GB of the host's 125 GB and the full build
(pack + SA-IS + BWT + dump + .sad) completed in 57 min nice'd at
priority 19 alongside a live session.

When the reads change (build_grch38 --force-reads), stages 2-3 re-run
automatically: --force-reads deletes the oracle artifacts and clears
the meta.json ready flag; this script rebuilds them and writes
ready=true last — bench.py refuses the config until then (the
round-4 flagship bench raced a half-built index; the marker closes
that race).

Run nice'd in the background:
  DART_TPU_BUILD_LOG=1 nohup nice -n19 python tools/prep_flagship.py &
"""

import argparse
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "tools"))


def log(msg):
    print(f"[{time.strftime('%H:%M:%S')}] prep_flagship: {msg}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--builder", choices=("ours", "ref"), default="ref")
    args = ap.parse_args()

    os.environ.setdefault("DART_TPU_BUILD_LOG", "1")
    import bench

    spec = bench.CONFIGS["grch38_pe_bam"]
    d = os.path.join(bench.WORK, "grch38_pe_bam")

    t0 = time.time()
    if not os.path.exists(os.path.join(d, "idx.bwt")):
        log(f"stage 1: build_grch38 (genome + reads + index, "
            f"builder={args.builder})...")
        subprocess.run([sys.executable,
                        os.path.join(HERE, "tools", "build_grch38.py"),
                        "--builder", args.builder],
                       check=True)
    log(f"stage 1 done ({time.time() - t0:.0f}s)")

    t1 = time.time()
    log("stage 2: reference parity oracle...")
    # construct the dataset dict directly: bench.ensure_dataset gates
    # on the ready marker this script has not written yet
    n = spec["n_reads"]
    ds = {"fq": (os.path.join(d, f"reads_{n}_1.fq"),
                 os.path.join(d, f"reads_{n}_2.fq")),
          "prefix": os.path.join(d, "idx"), "dir": d,
          "meta_path": os.path.join(d, "meta.json")}
    for p in [*ds["fq"]] + [ds["prefix"] + e for e in
                            (".bwt", ".pac", ".ann", ".amb", ".sa")]:
        if not os.path.exists(p):
            log(f"dataset incomplete after build ({p} missing)?!")
            return 1
    bench.ensure_parity_oracle("grch38_pe_bam", spec, ds)
    log(f"stage 2 done ({time.time() - t1:.0f}s)")

    t2 = time.time()
    log("stage 3: warm the derived-layout cache...")
    # import and call directly — runpy.run_path(run_name="__main__")
    # would execute warm_layout_cache's sys.exit() guard and the
    # SystemExit(0) would silently end prep before this point
    import warm_layout_cache

    warm_layout_cache.main(os.path.join(d, "idx"))
    import json

    meta_p = ds["meta_path"]
    meta = json.load(open(meta_p)) if os.path.exists(meta_p) else {}
    meta["ready"] = True  # written LAST: bench.py's readiness gate
    with open(meta_p, "w") as f:
        json.dump(meta, f)
    log(f"stage 3 done ({time.time() - t2:.0f}s); flagship ready "
        f"({time.time() - t0:.0f}s total)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
