"""Run the giant-table shard proof (__graft_entry__._giant_wide_shard_proof)
standalone on a virtual CPU mesh, warming the sharded layout cache
(idx.wtab<N>) so a later dryrun_multichip memmaps it instead of paying
the ~6 GB repack+write itself.

Usage: python tools/dryrun_giant.py [--devices 8] [--prefix <idx>]
"""

import argparse
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--prefix", default=os.path.join(
        os.environ.get("DART_TPU_BENCH_DIR", "/root/dart_tpu_bench"),
        "grch38_pe_bam", "idx"))
    args = ap.parse_args()

    os.environ["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={args.devices} "
        + os.environ.get("XLA_FLAGS", ""))
    os.environ["JAX_PLATFORMS"] = "cpu"

    if not os.path.exists(args.prefix + ".wtab"):
        print(f"layout cache {args.prefix}.wtab missing — run "
              f"tools/warm_layout_cache.py first", file=sys.stderr)
        return 1

    import __graft_entry__ as ge

    ge._giant_wide_shard_proof(args.devices, args.prefix)
    return 0


if __name__ == "__main__":
    sys.exit(main())
