#!/usr/bin/env python3
"""dart_tpu benchmark driver.

Prints ONE JSON line:
  {"metric": "...", "value": N, "unit": "reads/s", "vs_baseline": N, ...}

Headline workload (metric/value/vs_baseline): single-end 100 bp
RNA-seq reads (70% genomic with 0.5% mismatches, 30% spliced across
GT/AG introns) against a synthetic 8 Mbp two-chromosome genome — the
shape of the reference's own headline configs (BASELINE.json configs
1 and 3) at a size that builds and runs in minutes. More configs ride
along in the "configs" field: the same read mix against a 50 Mbp
genome (chr21 scale, BASELINE.json config 2), paired-end reads with
BAM output on the 8 Mbp genome, and — when its prebuilt dataset
exists (tools/build_grch38.py) — the flagship GRCh38-class config:
100 bp PE reads + BAM against a 3.09 Gbp hg38-proportioned genome
(BASELINE.json configs 4-5, the wide >2^31 engine).

Baseline: the reference Dart binary (hsinnan75/Dart, built from
/root/reference by tools/build_reference.sh) aligning the identical
reads with the identical BWA-format index, at -t 1; a dedicated -t 1
run's SAM (deterministic order) is the PARITY ORACLE: our output is
compared record-for-record IN ORDER (reference stale-FLAG divergences
normalized to the reference's intended values — single-end unmapped
reads and half-mapped pairs read uninitialized flag state; see
_norm_flags_pairwise, tests/test_bench_parity.py and README).

SAME-WINDOW protocol: reference and dart_tpu passes are interleaved
within one sampling loop (ref, ours, ref, ours, ...) so both rates
come from the same window of a shared host, where identical passes
can vary several-fold minute to minute. Each side keeps its
best pass and samples until both have two passes within 8%. Both
sides are timed over the full mapping phase excluding one-time
process startup: ours excludes interpreter/backend init, index load
and warm compiles (priced separately as setup_s); the reference's
per-pass index-load cost is measured with a 2-read input run
immediately BEFORE each timed pass and subtracted from that pass —
adjacent, so both share the same page-cache state (decisive for the
flagship's 13.6 GB index), and conservative (the tiny run also warms
the cache for the real pass; the baseline only shifts faster).
"""

from __future__ import annotations

import contextlib
import json
import os
import random
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "tools"))

# bench datasets live under /root (not /tmp): the GRCh38 flagship
# dataset takes hours to build and /tmp does not survive VM restarts
WORK = os.environ.get("DART_TPU_BENCH_DIR", "/root/dart_tpu_bench")
N_READS = int(os.environ.get("DART_TPU_BENCH_READS", "100000"))
READ_LEN = 100
SEED = 20260816
REF_BIN = "/tmp/dart_ref/bin/dart"
REF_IDX_BIN = "/tmp/dart_ref/bin/bwt_index"

CONFIGS = {
    "8mbp_se": {
        "genome": {"chr1": 5_000_000, "chr2": 3_000_000},
        "n_reads": N_READS, "paired": False, "bam": False,
        "passes": 10, "time_ref_build": True,
    },
    "50mbp_se": {
        "genome": {"chr1": 30_000_000, "chr2": 20_000_000},
        "n_reads": N_READS, "paired": False, "bam": False,
        "passes": 6, "time_ref_build": True,
    },
    "8mbp_pe_bam": {
        "genome": {"chr1": 5_000_000, "chr2": 3_000_000},
        "n_reads": (N_READS // 2) * 2, "paired": True, "bam": True,
        "passes": 6,
    },
    "grch38_pe_bam": {
        # prebuilt by tools/build_grch38.py (3.09 Gbp genome + 50k
        # pairs + wide index); skipped with a note if absent — the
        # build is hours of SA-IS and must not run inside the bench
        "genome": None, "prebuilt": True,
        "n_reads": 100_000, "paired": True, "bam": True,
        "passes": 4, "wall_budget_s": 3600,
    },
}


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def host_fault_mbps() -> float:
    """First-touch anonymous-memory speed (MB/s) right now. This host
    swings between ~6 MB/s and ~2700 MB/s for sustained fresh
    allocation (hypervisor ballooning); a degraded window multiplies
    every index load — ours AND each reference pass — so the recorded
    number travels with the results to qualify the window."""
    import mmap

    sz = 256 << 20
    m = mmap.mmap(-1, sz)
    t0 = time.time()
    step = mmap.PAGESIZE
    for off in range(0, sz, step):
        m[off] = 1
    dt = time.time() - t0
    m.close()
    return round(sz / 1e6 / max(dt, 1e-9), 1)


def _count_fastq_records(path: str) -> int:
    n = 0
    with open(path, "rb") as f:
        while True:
            b = f.read(1 << 24)
            if not b:
                break
            n += b.count(b"\n")
    return n // 4


def _read_genome(fa: str) -> dict[str, str]:
    genome: dict[str, str] = {}
    name = None
    parts: list[str] = []
    with open(fa) as f:
        for line in f:
            if line.startswith(">"):
                if name:
                    genome[name] = "".join(parts)
                name = line[1:].split()[0].strip()
                parts = []
            else:
                parts.append(line.strip())
    genome[name] = "".join(parts)
    return genome


def ensure_dataset(cname: str, spec: dict, work: str = WORK,
                   seed: int = SEED) -> dict | None:
    """Create (cached) genome + reads + our BWA-compatible index for
    one config under `work`, drawn from `seed`. Returns paths + our
    index build time (recorded the first time the index is built).
    Prebuilt configs (grch38) return None when their dataset is
    absent."""
    import make_fixtures as mf

    d = os.path.join(work, cname)
    fa = os.path.join(d, "genome.fa")
    prefix = os.path.join(d, "idx")
    meta_p = os.path.join(d, "meta.json")
    n = spec["n_reads"]
    if spec.get("prebuilt"):
        fq1 = os.path.join(d, f"reads_{n}_1.fq")
        fq2 = os.path.join(d, f"reads_{n}_2.fq")
        # readiness gate: the round-4 flagship bench raced a
        # still-running dataset prep — idx.bwt existed but idx.sa was
        # half-written and the reference SIGSEGV'd on it. Require
        # EVERY index file, both read files, and the prep-complete
        # marker prep_flagship writes last.
        need = [prefix + ext for ext in (".bwt", ".pac", ".ann", ".amb",
                                         ".sa")] + [fq1, fq2]
        missing = [p for p in need if not os.path.exists(p)]
        meta = json.load(open(meta_p)) if os.path.exists(meta_p) else {}
        if missing or not meta.get("ready"):
            why = (f"missing {', '.join(os.path.basename(p) for p in missing)}"
                   if missing else "meta.json lacks ready=true "
                   "(prep still running or interrupted)")
            log(f"bench[{cname}]: prebuilt dataset not ready ({why}); "
                f"run tools/prep_flagship.py; skipping config")
            return None
        # validate the read files actually hold n_reads records — a
        # stale fq pair at the expected path would silently skew
        # reads/sec (round-4 Weak #7)
        got = _count_fastq_records(fq1) + _count_fastq_records(fq2)
        if got != n:
            log(f"bench[{cname}]: read files hold {got} records, "
                f"spec says {n}; skipping config")
            return None
        return {"fq": (fq1, fq2), "prefix": prefix, "dir": d,
                "index_build_s": meta.get("index_build_s"),
                "ref_index_build_s": meta.get("ref_index_build_s"),
                "meta_path": meta_p}
    os.makedirs(d, exist_ok=True)
    if not os.path.exists(fa):
        log(f"bench[{cname}]: generating "
            f"{sum(spec['genome'].values())/1e6:.0f} Mbp genome...")
        rng = random.Random(seed)
        genome = mf.make_genome(rng, spec["genome"], n_runs=4)
        n_genes = max(50, sum(spec["genome"].values()) // 50000)
        chr1, genes = mf.plant_genes(rng, genome["chr1"], n_genes=n_genes)
        genome["chr1"] = chr1
        mf.write_fasta(fa, sorted(genome.items()))
        with open(os.path.join(d, "genes.txt"), "w") as f:
            for exs in genes:
                f.write("chr1\t" + ",".join(f"{a}-{b}" for a, b in exs) + "\n")
    if spec["paired"]:
        fq1 = os.path.join(d, f"reads_{n}_1.fq")
        fq2 = os.path.join(d, f"reads_{n}_2.fq")
        if not os.path.exists(fq1):
            log(f"bench[{cname}]: simulating {n // 2} read pairs...")
            rng = random.Random(seed + 1)
            genome = _read_genome(fa)
            r1, r2 = mf.sim_reads_paired(rng, genome, n // 2, READ_LEN,
                                         mismatch_rate=0.005)
            mf.write_reads_fastq(fq1, r1)
            mf.write_reads_fastq(fq2, r2)
        fq = (fq1, fq2)
    else:
        fq1 = os.path.join(d, f"reads_{n}.fq")
        if not os.path.exists(fq1):
            log(f"bench[{cname}]: simulating {n} reads...")
            rng = random.Random(seed + 1)
            genome = _read_genome(fa)
            genes = []
            with open(os.path.join(d, "genes.txt")) as f:
                for line in f:
                    _, exs = line.split("\t")
                    genes.append([tuple(map(int, p.split("-")))
                                  for p in exs.split(",")])
            n_spliced = n * 3 // 10
            reads = mf.sim_reads_genomic(rng, genome, n - n_spliced,
                                         READ_LEN, 0.005, tag="g")
            reads += mf.sim_reads_spliced(rng, "chr1", genome["chr1"], genes,
                                          n_spliced, READ_LEN, 0.005, tag="s")
            rng.shuffle(reads)
            mf.write_reads_fastq(fq1, reads)
        fq = (fq1, None)
    if not os.path.exists(prefix + ".bwt"):
        log(f"bench[{cname}]: building index...")
        from dart_tpu.index import build_index

        t0 = time.time()
        build_index(fa, prefix)
        meta = json.load(open(meta_p)) if os.path.exists(meta_p) else {}
        meta["index_build_s"] = round(time.time() - t0, 2)
        with open(meta_p, "w") as f:
            json.dump(meta, f)
    meta = json.load(open(meta_p)) if os.path.exists(meta_p) else {}
    return {"fq": fq, "prefix": prefix, "dir": d,
            "index_build_s": meta.get("index_build_s"),
            "meta_path": meta_p}


def ensure_reference() -> bool:
    if os.path.exists(REF_BIN):
        return True
    try:
        subprocess.run(["bash", os.path.join(HERE, "tools",
                                             "build_reference.sh")],
                       check=True, capture_output=True, timeout=900)
        return True
    except Exception as e:
        log(f"bench: cannot build reference dart ({e})")
        return False


def _builder_fingerprint() -> str:
    """Version key for cached index-build timings: a hash of the
    builder sources, so any builder change invalidates the cache."""
    import hashlib

    h = hashlib.sha256()
    for rel in ("dart_tpu/native/sais.cpp", "dart_tpu/index/builder.py",
                "dart_tpu/index/packer.py"):
        with open(os.path.join(HERE, rel), "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:12]


def time_index_builds(cname: str, spec: dict, ds: dict):
    """Time BOTH builders on the identical genome, interleaved
    (ours, ref, ours, ref) and best-of-2 per side — the same
    same-window discipline as the aligner measurement: single-shot
    builds on this host vary >2x between adjacent runs (measured
    323 s then 143 s for the identical 50 Mbp build). Cached in the
    dataset meta as a pair; returns (ours_s, ref_s)."""
    meta = json.load(open(ds["meta_path"])) if os.path.exists(ds["meta_path"]) else {}
    # cache keyed on the builder sources: a stale pair must not keep
    # reporting after the builder improves (round-3 disease — the
    # README/driver contradiction on builder times)
    ver = _builder_fingerprint()
    if "build_pair_s" in meta and meta.get("build_pair_ver") == ver:
        return tuple(meta["build_pair_s"])
    if not spec.get("time_ref_build") or not os.path.exists(REF_IDX_BIN):
        # prebuilt configs carry whatever times their prep recorded
        # (the flagship's reference bwt_index time from build_grch38)
        return ds["index_build_s"], ds.get("ref_index_build_s")
    from dart_tpu.index import build_index

    fa = os.path.join(ds["dir"], "genome.fa")
    out_prefix = os.path.join(ds["dir"], "refidx")
    log(f"bench[{cname}]: timing both index builders (2 interleaved "
        f"passes each)...")
    ours_t: list[float] = []
    ref_t: list[float] = []
    for _ in range(2):
        t0 = time.time()
        build_index(fa, out_prefix)
        ours_t.append(time.time() - t0)
        for ext in (".bwt", ".sa", ".pac", ".ann", ".amb", ".sad"):
            with contextlib.suppress(FileNotFoundError):
                os.unlink(out_prefix + ext)
        t0 = time.time()
        subprocess.run([REF_IDX_BIN, fa, out_prefix], check=True,
                       capture_output=True, timeout=7200)
        ref_t.append(time.time() - t0)
        for ext in (".bwt", ".sa", ".pac", ".ann", ".amb"):
            with contextlib.suppress(FileNotFoundError):
                os.unlink(out_prefix + ext)
    ours = round(min(ours_t), 2)
    ref = round(min(ref_t), 2)
    meta["build_pair_s"] = [ours, ref]
    meta["build_pair_ver"] = ver
    # qualify the measurement window: build times from a degraded
    # anon-fault window (post-VM-restart ballooning) are flagged so a
    # later report can re-measure instead of trusting them
    meta["build_pair_fault_mbps"] = host_fault_mbps()
    with open(ds["meta_path"], "w") as f:
        json.dump(meta, f)
    log(f"bench[{cname}]: index build: ours {ours:.0f}s, "
        f"reference bwt_index {ref:.0f}s (best of 2 each)")
    return ours, ref


def _ref_cmd(spec: dict, ds: dict, out: str | None, bam: bool,
             silent: bool = True):
    fq1, fq2 = ds["fq"]
    cmd = [REF_BIN, "-i", ds["prefix"], "-f", fq1]
    if fq2:
        cmd += ["-f2", fq2]
    cmd += ["-t", "1", "-mis", "5",
            "-j", os.path.join(ds["dir"], "ref.junctions.tab")]
    if silent:
        cmd += ["-silent"]
    if bam:
        cmd += ["-bo", out]
    elif out:
        cmd += ["-o", out]
    return cmd


def ensure_parity_oracle(cname: str, spec: dict, ds: dict) -> str | None:
    """The reference's -t 1 SAM (deterministic order): cached, untimed."""
    ref_sam = os.path.join(ds["dir"], f"ref_{spec['n_reads']}.sam")
    if os.path.exists(ref_sam):
        return ref_sam
    if not ensure_reference():
        return None
    log(f"bench[{cname}]: producing reference parity oracle...")
    # untimed + cached, so give it a day: a GRCh38-scale -t 1 pass in
    # a degraded host window can legitimately exceed 2 h, and a
    # timeout here silently discards hours of prep
    subprocess.run(_ref_cmd(spec, ds, ref_sam, bam=False), check=True,
                   capture_output=True,
                   timeout=int(os.environ.get("DART_TPU_ORACLE_TIMEOUT",
                                              "86400")))
    return ref_sam


def _reference_tiny_cmd(cname: str, spec: dict, ds: dict):
    """Command for a 2-read reference run: process startup + index
    load with negligible alignment. Timed immediately BEFORE each real
    reference pass and subtracted from it — the adjacent measurement
    shares the real pass's page-cache state, which matters enormously
    for the flagship's 13.6 GB index (a cold-cache load costs 100+ s,
    a warm one seconds; round 5's first flagship bench subtracted one
    up-front cold measurement from later warm passes and clamped them
    to 0.00 s). Still conservative: the tiny run also warms the cache
    for the real pass that follows, shifting the baseline faster."""
    tiny = os.path.join(ds["dir"], "tiny.fq")
    if not os.path.exists(tiny):
        with open(ds["fq"][0]) as f, open(tiny, "w") as out:
            for _ in range(8):
                line = f.readline()
                if not line:
                    break
                out.write(line)
    tiny_ds = dict(ds, fq=(tiny, None))
    tiny_spec = dict(spec, paired=False)
    return _ref_cmd(tiny_spec, tiny_ds,
                    os.path.join(ds["dir"], "tiny.sam"), bam=False)


def _converged(times: list[float]) -> bool:
    """Two passes within 8% of the best = quiet window found."""
    if len(times) < 2:
        return False
    s = sorted(times)
    return s[1] <= s[0] * 1.08


def measure_both(cname: str, spec: dict, ds: dict):
    """SAME-WINDOW measurement: interleave reference and dart_tpu
    passes in one loop so both rates come from the same host window.
    Returns (our_rate, ref_rate, meta)."""
    from dart_tpu.aligner import DartAligner, make_engine
    from dart_tpu.config import DartConfig
    from dart_tpu.index import load_index

    have_ref = ensure_reference()

    t_setup = time.time()
    cfg = DartConfig()
    cfg.engine = "jax"
    cfg.max_mismatch = 5
    cfg.silent = True
    fq1, fq2 = ds["fq"]
    cfg.read_files_1 = [fq1]
    if fq2:
        cfg.read_files_2 = [fq2]
        cfg.pair_end = True
    ext = "bam" if spec["bam"] else "sam"
    cfg.output_file = os.path.join(ds["dir"], f"dart.{ext}")
    cfg.output_format = 1 if spec["bam"] else 0
    cfg.sj_file = os.path.join(ds["dir"], "dart.junctions.tab")
    idx = load_index(ds["prefix"])
    engine = make_engine(idx, cfg)
    # warm compile caches and device-side program loads with one
    # full uncounted pass (persistent XLA cache makes
    # this fast after the first-ever run on a machine)
    warm = DartAligner(idx, cfg, engine)
    with contextlib.redirect_stdout(sys.stderr):
        warm.run()
    # the engine holds its own (device) tables and per-pass alignment
    # touches only ref_ascii_padded + the chromosome maps; drop the
    # engine-build-only host arrays (~17 GB at GRCh38 scale) so the
    # interleaved reference passes fault their index against less
    # memory-balloon pressure on this host
    import gc

    for f in ("bwt", "occ", "sa_samples", "sad_samples", "ref_codes"):
        if hasattr(idx, f):
            setattr(idx, f, None)
    gc.collect()
    setup_s = time.time() - t_setup

    ref_out = os.path.join(ds["dir"], "ref_timed." + ("bam" if spec["bam"]
                                                      else "sam"))
    # prebuilt (flagship-scale) configs time the reference by its OWN
    # mapping-phase self-report ("processed in N seconds", printed
    # from a post-load clock, Mapping.cpp:594): the index load there
    # is ~190 s against a ~7 s align phase, so subtracting a
    # separately-timed load would difference two large noisy numbers
    # (round 5 measured adjacent tiny-loads varying by more than the
    # whole align phase). 1-second print resolution is accepted for
    # passes >= 5 s; small configs keep the adjacent-load-subtraction
    # protocol, whose loads are sub-second and stable.
    self_timed = bool(spec.get("prebuilt"))
    ref_cmd = (_ref_cmd(spec, ds, ref_out, bam=spec["bam"],
                        silent=not self_timed) if have_ref else None)
    tiny_cmd = (_reference_tiny_cmd(cname, spec, ds)
                if have_ref and not self_timed else None)

    ours: list[float] = []
    ref: list[float] = []
    ref_loads: list[float] = []
    best_stats: dict = {}
    max_passes = spec["passes"] + 4
    # soft wall budget: in a degraded host window one GRCh38-scale
    # reference pass can cost 25+ min of page faulting; once both
    # sides have at least one pass, stop sampling at the budget and
    # record what we have (spread/passes expose the quality)
    budget_s = spec.get("wall_budget_s", 1800)
    t_loop = time.time()
    for i in range(max_passes):
        if (time.time() - t_loop > budget_s and ours
                and (ref_cmd is None or ref)):
            log(f"bench[{cname}]: wall budget {budget_s}s exhausted "
                f"after {len(ours)}+{len(ref)} passes")
            break
        if ref_cmd is not None and not (len(ref) >= 2 and _converged(ref)):
            if self_timed:
                t0 = time.time()
                r = subprocess.run(ref_cmd, check=True,
                                   capture_output=True, timeout=7200)
                raw = time.time() - t0
                import re as _re

                m = _re.findall(rb"processed in (\d+) seconds",
                                r.stdout + r.stderr)
                if not m:
                    raise RuntimeError(
                        "reference self-report line not found")
                ref.append(max(float(m[-1]), 1.0))
                ref_loads.append(round(raw - ref[-1], 2))
                log(f"bench[{cname}]: reference pass: {ref[-1]:.0f}s "
                    f"self-reported mapping phase "
                    f"({raw:.0f}s wall incl. load)")
            else:
                t0 = time.time()
                subprocess.run(tiny_cmd, check=True, capture_output=True,
                               timeout=7200)
                ref_load = time.time() - t0
                ref_loads.append(round(ref_load, 2))
                t0 = time.time()
                subprocess.run(ref_cmd, check=True, capture_output=True,
                               timeout=7200)
                ref.append(max(time.time() - t0 - ref_load, 1e-3))
                log(f"bench[{cname}]: reference pass: {ref[-1]:.2f}s "
                    f"(+{ref_load:.2f}s adjacent load)")
        if not (len(ours) >= 3 and _converged(ours)):
            aligner = DartAligner(idx, cfg, engine)
            t0 = time.time()
            with contextlib.redirect_stdout(sys.stderr):
                aligner.run()
            ours.append(time.time() - t0)
            if ours[-1] <= min(ours):
                # the recorded rate is the best pass; its stage split
                # travels with it so regressions are localizable
                # (device wait vs native finalize vs output encode)
                best_stats = {k: round(v, 3) if isinstance(v, float) else v
                              for k, v in aligner.stats.items()}
            log(f"bench[{cname}]: dart_tpu pass: {ours[-1]:.2f}s")
        if (len(ours) >= 3 and _converged(ours)
                and (ref_cmd is None or (len(ref) >= 2 and _converged(ref)))
                and i + 1 >= spec["passes"] - 1):
            break
    best = min(ours)
    rate = spec["n_reads"] / best
    spread = max(ours) / best
    ref_rate = (spec["n_reads"] / min(ref)) if ref else None
    if ref:
        log(f"bench[{cname}]: reference: {min(ref):.2f}s "
            f"({ref_rate:.0f} reads/s, -t 1, {len(ref)} passes)")
    log(f"bench[{cname}]: dart_tpu: {best:.2f}s ({rate:.0f} reads/s; "
        f"{len(ours)} passes, spread {spread:.2f}x; "
        f"setup+warmup {setup_s:.1f}s)")
    import statistics

    med_rate = spec["n_reads"] / statistics.median(ours)
    ref_med_rate = (spec["n_reads"] / statistics.median(ref)) if ref else None
    return rate, ref_rate, {
        "wall_s": round(best, 3), "setup_s": round(setup_s, 1),
        "passes": len(ours), "spread": round(spread, 2),
        # every pass + the median: best-of-N under a noisy host is
        # soft; the median and full list make the recorded
        # rate auditable. vs_baseline_median is the median-vs-median
        # ratio: our pass spread is wider than the reference's, so
        # best-vs-best is structurally flattering (round-4 Weak #4) —
        # both ratios travel together.
        "ours_passes_s": [round(t, 2) for t in ours],
        "median_reads_per_sec": round(med_rate, 1),
        "vs_baseline_median": (round(med_rate / ref_med_rate, 4)
                               if ref_med_rate else None),
        "stage_split": best_stats,
        "ref_wall_s": round(min(ref), 3) if ref else None,
        "ref_passes_s": [round(t, 2) for t in ref],
        "ref_load_s": ref_loads,
        "ref_passes": len(ref), "same_window": bool(ref),
    }


def _norm_flags_pairwise(recs: list[tuple[str, int, str]]) -> list[int]:
    """Return normalized FLAG values for reference -t 1 records.

    Two documented reference stale-FLAG bug classes (it formats flags
    from uninitialized/stale state, Mapping.cpp:74-186):
    - single-end unmapped reads: FLAG is garbage; ours is always 4.
    - half-mapped pairs (exactly one end unmapped): the reference
      sometimes emits stale proper-pair/mate bits (e.g. 83/99/147).
    - both-ends-unmapped pairs: same stale emission (e.g. 83/163 on
      rname-* records); the intended values are 77/141
      (Mapping.cpp:148-151 and 180-182: 0x41|0x4|0x8 / 0x81|0x4|0x8),
      which is what we emit.
      The normalization target is the reference's INTENDED flags
      (Mapping.cpp:101-186, where mate 2 is stored RC'd — proven by
      the toy goldens, where the reference emits them cleanly:
      tests/golden/c5_pe.sam's 105/149 pairs), which is exactly what
      dart_tpu's faithful port emits (pipeline/report.py:41-95):
        mapped end:  1|8|first-last| (0x10 if itself reverse else 0x20)
        unmapped end: 1|4|first-last| (0x20 if mate reverse else 0x10)
      Only the mapped end's own strand bit (consistent with the SEQ
      it printed) is trusted from the stale value.
    recs: (qname, flag, rname) in file order."""
    out = [f for _, f, _ in recs]
    i = 0
    n = len(recs)
    while i < n:
        q, f, rn = recs[i]
        if not f & 1:
            if rn == "*":
                out[i] = 4
            i += 1
            continue
        if i + 1 < n and recs[i + 1][0] == q and recs[i + 1][1] & 1:
            q2, f2, rn2 = recs[i + 1]
            un1 = rn == "*"
            un2 = rn2 == "*"
            if un1 != un2:
                (mi, ui) = (i + 1, i) if un1 else (i, i + 1)
                mf = out[mi]
                uf = out[ui]
                rev = bool(mf & 0x10)
                out[mi] = 1 | 8 | (mf & 0xC0) | (0x10 if rev else 0x20)
                out[ui] = 1 | 4 | (uf & 0xC0) | (0x20 if rev else 0x10)
            elif un1 and un2:
                out[i] = 1 | 4 | 8 | (out[i] & 0xC0)
                out[i + 1] = 1 | 4 | 8 | (out[i + 1] & 0xC0)
            i += 2
            continue
        i += 1
    return out


def _load_ref_records(ref_sam: str):
    recs = []
    lines = []
    with open(ref_sam) as f:
        for line in f:
            if line.startswith("@"):
                continue
            p = line.rstrip("\n").split("\t")
            recs.append((p[0], int(p[1]), p[2]))
            lines.append(p)
    flags = _norm_flags_pairwise(recs)
    for p, fl in zip(lines, flags):
        p[1] = str(fl)
    return lines


def parity_check(cname: str, spec: dict, ds: dict, ref_sam: str | None) -> str:
    """Record-for-record IN-ORDER comparison against the reference's
    -t 1 SAM (its order is deterministic = input order, like ours),
    with the reference's stale-FLAG divergences normalized to its
    intended values (which is what we emit)."""
    if ref_sam is None or not os.path.exists(ref_sam):
        return "n/a"
    want_rows = _load_ref_records(ref_sam)
    if spec["bam"]:
        sys.path.insert(0, os.path.join(HERE, "tests"))
        from test_bam import decode_bam

        _, _, records = decode_bam(os.path.join(ds["dir"], "dart.bam"))
        got = []
        for rec in records:
            got.append((rec["name"], rec["flag"], rec["pos"], rec["cigar"]))
        want2 = []
        for p in want_rows:
            want2.append((p[0], int(p[1]),
                          int(p[3]) if p[2] != "*" else 0, p[5]))
        # BAM keeps the XS:A tag the reference truncates; compare core
        # fields only (name/flag/pos/cigar)
        same = sum(1 for x, y in zip(got, want2) if x == y)
        return f"{same}/{max(len(got), len(want2))} records (BAM core fields, in order)"
    want = ["\t".join(p) for p in want_rows]
    with open(os.path.join(ds["dir"], "dart.sam")) as f:
        got = [l.rstrip("\n") for l in f if not l.startswith("@")]
    same = sum(1 for x, y in zip(got, want) if x == y)
    return f"{same}/{max(len(got), len(want))} identical SAM records (in order)"


def junction_parity(ds: dict) -> str:
    """Record-for-record diff of the junction tables (both sides sort
    by forward-genome coordinate, so order is deterministic). The
    reference writes ref.junctions.tab on every timed pass
    (Mapping.cpp:697-716); ours writes dart.junctions.tab — half the
    output contract, previously never compared (round-4 Missing #2)."""
    ref_p = os.path.join(ds["dir"], "ref.junctions.tab")
    got_p = os.path.join(ds["dir"], "dart.junctions.tab")
    if not (os.path.exists(ref_p) and os.path.exists(got_p)):
        return "n/a"
    with open(ref_p) as f:
        want = f.read().splitlines()
    with open(got_p) as f:
        got = f.read().splitlines()
    same = sum(1 for x, y in zip(got, want) if x == y)
    return (f"{same}/{max(len(got), len(want))} identical junction "
            f"records (ours {len(got)}, ref {len(want)})")


def main() -> int:
    results = {}
    fault_mbps = host_fault_mbps()
    log(f"bench: host anon-fault speed {fault_mbps:.0f} MB/s "
        f"({'DEGRADED window - index loads will crawl' if fault_mbps < 200 else 'ok'})")
    for cname, spec in CONFIGS.items():
        # fail-soft per config: a crash in one config (e.g. the
        # flagship GRCh38 run hitting a memory or time limit) must not
        # lose the other configs' recorded numbers
        try:
            ds = ensure_dataset(cname, spec)
            if ds is None:
                continue
            build_s, ref_build_s = time_index_builds(cname, spec, ds)
            oracle = ensure_parity_oracle(cname, spec, ds)
            rate, ref_rate, meta = measure_both(cname, spec, ds)
            note = parity_check(cname, spec, ds, oracle)
            sj_note = junction_parity(ds)
            log(f"bench[{cname}]: parity: {note}; junctions: {sj_note}")
        except Exception as e:  # noqa: BLE001
            log(f"bench[{cname}]: FAILED: {type(e).__name__}: {e}")
            results[cname] = {"error": f"{type(e).__name__}: {e}"}
            continue
        results[cname] = {
            "reads_per_sec": round(rate, 1),
            "vs_baseline": round(rate / ref_rate, 4) if ref_rate else None,
            "baseline_reads_per_sec": round(ref_rate, 1) if ref_rate else None,
            "parity": note,
            "sj_parity": sj_note,
            "index_build_s": build_s,
            "ref_index_build_s": ref_build_s,
            **meta,
        }
    head = results.get("8mbp_se", {})
    print(json.dumps({
        "metric": "rna_seq_align_throughput",
        "value": head.get("reads_per_sec"),
        "unit": "reads/s",
        "vs_baseline": head.get("vs_baseline"),
        "host_fault_mbps": fault_mbps,
        "configs": results,
    }))
    return 0 if "reads_per_sec" in head else 1


if __name__ == "__main__":
    sys.exit(main())
