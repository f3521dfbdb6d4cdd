"""Sustained-stream run: >=1M reads through the aligner with
checkpointing on, recording per-chunk steady-state throughput, RSS,
and checkpoint overhead (evidence toward BASELINE config 5, the
billion-read streaming regime; the reference streams chunks through
its pthread pool with no memory growth, Mapping.cpp:579-681).

The input is the cached 100k-read bench set passed as N separate -f
files (the multi-file input path, reference main.cpp:142-151), so no
new dataset is needed. Per-chunk wall times come from wrapping the
aligner's emit path; RSS is sampled from /proc/self/status.

Usage: python tools/sustained_stream.py [--repeats 10] [--checkpoint]
Emits one JSON line at the end; full per-chunk log on stderr.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def rss_mb() -> float:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS"):
                return int(line.split()[1]) / 1024.0
    return 0.0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--repeats", type=int, default=10)
    ap.add_argument("--checkpoint", action="store_true")
    ap.add_argument("--ckpt-interval", type=float, default=0.0,
                    help="min seconds between checkpoint saves "
                    "(0 = every chunk)")
    ap.add_argument("--dataset", default=os.path.join(
        os.environ.get("DART_TPU_BENCH_DIR", "/root/dart_tpu_bench"),
        "8mbp_se"))
    args = ap.parse_args()

    prefix = os.path.join(args.dataset, "idx")
    fq = os.path.join(args.dataset, "reads_100000.fq")
    if not os.path.exists(prefix + ".bwt") or not os.path.exists(fq):
        print(f"missing bench dataset under {args.dataset} "
              f"(run python bench.py once)", file=sys.stderr)
        return 1

    from dart_tpu.aligner import DartAligner, make_engine
    from dart_tpu.config import DartConfig
    from dart_tpu.index import load_index

    cfg = DartConfig()
    cfg.engine = "jax"
    cfg.max_mismatch = 5
    cfg.silent = True
    cfg.read_files_1 = [fq] * args.repeats
    cfg.output_file = "/tmp/sustained_stream.sam"
    cfg.sj_file = "/tmp/sustained_stream.tab"
    cfg.checkpoint = args.checkpoint
    cfg.ckpt_interval_s = args.ckpt_interval

    for stale in (cfg.output_file + ".ckpt",):
        if os.path.exists(stale):
            os.remove(stale)

    idx = load_index(prefix)
    engine = make_engine(idx, cfg)

    # warm pass on one file (compiles; uncounted)
    warm_cfg = DartConfig()
    for k, v in vars(cfg).items():
        setattr(warm_cfg, k, v)
    warm_cfg.read_files_1 = [fq]
    warm_cfg.checkpoint = False
    t0 = time.time()
    DartAligner(idx, warm_cfg, engine).run()
    print(f"[warm] {time.time() - t0:.1f}s", file=sys.stderr)

    aligner = DartAligner(idx, cfg, engine)
    chunk_log = []
    orig_process = aligner.process_chunk
    last = time.time()

    def process_chunk(reads, pair_end, fastq):
        nonlocal last
        out = orig_process(reads, pair_end, fastq)
        now = time.time()
        chunk_log.append((len(reads), now - last, rss_mb()))
        last = now
        return out

    aligner.process_chunk = process_chunk
    # the pipelined path bypasses process_chunk; hook _finish_chunk
    # (it has the chunk's read count)
    orig_fin = aligner._finish_chunk

    def finish_chunk(reads, job, pair_end, fastq, emit, on_wait=None):
        nonlocal last
        out = orig_fin(reads, job, pair_end, fastq, emit, on_wait)
        now = time.time()
        chunk_log.append((len(reads), now - last, rss_mb()))
        last = now
        return out

    aligner._finish_chunk = finish_chunk

    t0 = time.time()
    last = t0
    aligner.run()
    wall = time.time() - t0
    total = aligner.counters["total"]

    rates = []
    for i, (n, dt, mb) in enumerate(chunk_log):
        nn = n if n else total // max(len(chunk_log), 1)
        rates.append(nn / max(dt, 1e-9))
        print(f"[chunk {i:3d}] {nn} reads  {dt:6.3f}s  "
              f"{rates[-1]:9.0f} reads/s  rss {mb:7.1f} MB",
              file=sys.stderr)

    n = len(rates)
    first_q = sorted(rates[: max(n // 4, 1)])[len(rates[: max(n // 4, 1)]) // 2]
    last_q = sorted(rates[-max(n // 4, 1):])[len(rates[-max(n // 4, 1):]) // 2]
    rss_first = chunk_log[min(2, n - 1)][2]
    rss_last = chunk_log[-1][2]
    result = {
        "config": "sustained_stream",
        "total_reads": int(total),
        "wall_s": round(wall, 1),
        "reads_per_sec": round(total / wall, 1),
        "chunks": n,
        "median_rate_first_quarter": round(first_q, 1),
        "median_rate_last_quarter": round(last_q, 1),
        "rate_drift": round(last_q / first_q, 3),
        "rss_mb_start": round(rss_first, 1),
        "rss_mb_end": round(rss_last, 1),
        "checkpoint": bool(args.checkpoint),
        "ckpt_interval_s": args.ckpt_interval,
    }
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
