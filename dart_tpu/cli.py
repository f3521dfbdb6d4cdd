"""Flag-compatible CLI (reference: main.cpp:96-239).

Every reference flag is accepted with identical defaults and clamping;
`index` builds an index. dart_tpu extensions use `--`-prefixed names.
"""

from __future__ import annotations

import os
import sys

from .config import DartConfig
from .constants import VERSION_STR


def usage(prog: str) -> None:
    print(f"""
DART-TPU (JAX rebuild of DART v{VERSION_STR})

Usage: {prog} -i Index_Prefix -f <ReadFile_A1 ...> [-f2 <ReadFile_A2 ...>] -o|-bo Output
       {prog} index ref.fa prefix

Options: -t INT        number of threads [4]
         -f            files with #1 mates reads
         -f2           files with #2 mates reads
         -mis INT      maximal number of mismatches in an alignment
         -max_dup INT  maximal number of repetitive fragments (100-10000) [100]
         -o            alignment filename in SAM format
         -bo           alignment filename in BAM format
         --bam-level INT  BGZF compression level 0-9 [1]
         -j            splice junction output filename [junctions.tab]
         -m            output multiple alignments [false]
         -all_sj       detect all splice junctions regardless of mapq [false]
         -p            paired-end reads are interlaced in the same file
         -unique       output unique alignments
         -max_intron   the maximal intron size [500000]
         -min_intron   the minimal intron size [10]
         -v            version
Extensions:
         --engine E    compute engine: auto | jax | numpy [auto]
         --mesh SPEC   multi-device mesh, e.g. data=4 or data=2,index=2
                       (reads data-parallel; index range-sharded for
                       genomes beyond one device's memory)
         --batch N     reads per device chunk [65536]
         --checkpoint  per-chunk resume cursor (SAM/BAM; per host
                       when distributed)
         --ckpt-interval S  min seconds between checkpoint saves
                       (0 = every chunk; throttling amortizes the
                       ~0.15 s durable save over long streams) [0]
         --stats       per-stage timing report
         --profile DIR write a jax.profiler trace
         --no-native   pure-Python host pipeline (no C++ toolchain)
         --dist-coordinator HOST:PORT / --dist-nprocs N / --dist-pid I
                       multi-process run via jax.distributed (one card
                       per process)
""")


def parse_args(argv: list[str]) -> DartConfig | None:
    cfg = DartConfig()
    i = 0
    n = len(argv)
    while i < n:
        a = argv[i]
        if a == "-i":
            i += 1
            cfg.index_prefix = argv[i]
        elif a == "-f":
            while i + 1 < n and not argv[i + 1].startswith("-"):
                i += 1
                cfg.read_files_1.append(argv[i])
        elif a == "-f2":
            while i + 1 < n and not argv[i + 1].startswith("-"):
                i += 1
                cfg.read_files_2.append(argv[i])
        elif a == "-t":
            i += 1
            cfg.threads = int(argv[i])
            if cfg.threads <= 0:
                print("Warning! Thread number should be a positive number!")
                cfg.threads = 4
        elif a == "-o":
            i += 1
            cfg.output_format = 0
            cfg.output_file = argv[i]
        elif a == "-bo":
            i += 1
            cfg.output_format = 1
            cfg.output_file = argv[i]
        elif a in ("--bam-level", "-bam_level") and i + 1 < n:
            i += 1
            cfg.bam_level = min(max(int(argv[i]), 0), 9)
        elif a == "-mis" and i + 1 < n:
            i += 1
            cfg.max_mismatch = int(argv[i])
        elif a == "-max_dup" and i + 1 < n:
            i += 1
            cfg.max_dup_num = min(max(int(argv[i]), 100), 10000)
        elif a == "-silent":
            cfg.silent = True
        elif a == "-j":
            i += 1
            cfg.sj_file = argv[i]
        elif a == "-p":
            cfg.pair_end = True
        elif a == "-m":
            cfg.multi_hit = True
        elif a == "-unique":
            cfg.unique_only = True
        elif a == "-all_sj":
            cfg.find_all_junction = True
        elif a == "-max_intron":
            i += 1
            cfg.max_intron_size = max(int(argv[i]), 100000)
        elif a == "-min_intron":
            i += 1
            cfg.min_intron_size = int(argv[i])
        elif a in ("-d", "-debug"):
            cfg.debug = True
        elif a in ("-v", "--version"):
            print(f"DART-TPU (reference parity v{VERSION_STR})\n")
            return None
        elif a == "--engine":
            i += 1
            cfg.engine = argv[i]
        elif a == "--mesh":
            i += 1
            cfg.mesh = argv[i]
        elif a == "--batch":
            i += 1
            cfg.batch_reads = max(2, int(argv[i]))
        elif a == "--no-native":
            cfg.native = False
        elif a == "--checkpoint":
            cfg.checkpoint = True
        elif a == "--ckpt-interval":
            i += 1
            cfg.ckpt_interval_s = float(argv[i])
        elif a == "--stats":
            cfg.stats = True
        elif a == "--profile":
            i += 1
            cfg.profile_dir = argv[i]
        elif a == "--dist-coordinator":
            i += 1
            cfg.dist_coordinator = argv[i]
        elif a == "--dist-nprocs":
            i += 1
            cfg.dist_nprocs = int(argv[i])
        elif a == "--dist-pid":
            i += 1
            cfg.dist_pid = int(argv[i])
        else:
            print(f"Error! Unknown parameter: {a}", file=sys.stderr)
            usage("dart-tpu")
            sys.exit(1)
        i += 1
    return cfg


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    prog = "dart-tpu"
    if not argv or argv[0] == "-h":
        usage(prog)
        return 0
    if argv[0] == "index":
        if len(argv) == 3:
            from .index import build_index

            build_index(argv[1], argv[2])
            return 0
        print(f"usage: {prog} index ref.fa prefix", file=sys.stderr)
        return 1
    if argv[0] in ("eva", "fluxeva", "sjeva"):
        from .evaluation import main as eval_main

        return eval_main(argv)

    cfg = parse_args(argv)
    if cfg is None:
        return 0
    if not cfg.read_files_1:
        print("Error! Please specify a valid read input!", file=sys.stderr)
        usage(prog)
        return 1
    if cfg.read_files_2 and len(cfg.read_files_1) != len(cfg.read_files_2):
        print("Error! Paired-end reads input numbers do not match!", file=sys.stderr)
        return 1
    for p in cfg.read_files_1 + cfg.read_files_2:
        if not os.path.exists(p):
            print(f"Cannot access file:[{p}]", file=sys.stderr)
            return 1
    from .index import load_index
    from .aligner import DartAligner

    if not cfg.index_prefix or not os.path.exists(cfg.index_prefix + ".ann"):
        print("Error! Please specify a valid reference index!", file=sys.stderr)
        usage(prog)
        return 1
    if cfg.dist_nprocs > 1:
        from .parallel.distributed import run_distributed

        return run_distributed(cfg, cfg.dist_coordinator, cfg.dist_nprocs,
                               cfg.dist_pid)
    print("Load the genome index files...", file=sys.stderr)
    idx = load_index(cfg.index_prefix)
    DartAligner(idx, cfg).run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
