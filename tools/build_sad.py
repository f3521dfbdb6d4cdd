"""Regenerate ONLY the .sad dense-sample file for an existing index.

The .sad is dart_tpu's device extension (builder.write_sad_file): denser
SA samples than the BWA .sa's every-32, because a batched LF-walk
costs its LONGEST lane. An index built by the reference bwt_index (or
stock bwa) has no .sad; this tool derives one without touching the
five BWA files — it reruns the SA-IS core (the suffix array cannot be
densified from the every-32 samples) and writes the samples at the
builder's current wide/narrow interval policy.

Flagship-scale run: ~60 min, ~75 GB peak RSS — run nice'd:
  nohup nice -n19 python tools/build_sad.py /path/idx genome.fa &
Invalidates the engines' derived-layout caches automatically (their
metadata is keyed on the effective sa_intv); re-run
tools/warm_layout_cache.py afterwards to pay the re-derivation once.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from dart_tpu.index import builder, packer


def log(m):
    print(f"[{time.strftime('%H:%M:%S')}] {m}", flush=True)


def main(prefix: str, fasta: str) -> int:
    os.environ.setdefault("DART_TPU_BUILD_LOG", "1")
    log(f"packing {fasta}")
    pg = packer.pack_fasta(fasta, seed=11)
    text = builder.full_text(pg.seq2)
    seq_len = int(text.shape[0])
    log(f"SA-IS over {seq_len:,} positions")
    core = builder._core_native(text)
    if core is None:
        log("native SA-IS core unavailable")
        return 1
    sa_full, _bwt, _primary, _payload = core
    del text, _bwt, _payload

    # sanity: our samples at every-32 must equal the existing .sa
    with open(prefix + ".sa", "rb") as f:
        sheader = np.frombuffer(f.read(56), dtype="<u8")
        sa_intv = int(sheader[5])
        want = np.frombuffer(f.read(8 * 1024), dtype="<u8")[:1024]
    got = sa_full[::sa_intv][1:1025].astype(np.uint64)
    if not (got[:want.shape[0]] == want).all():
        log("SA mismatch vs existing .sa — refusing to write .sad")
        return 1
    log("every-32 samples match the existing .sa")

    wide = seq_len >= 2**31
    intv = max(builder.SAD_INTERVAL, builder.SA_INTERVAL // 2) if wide \
        else builder.SAD_INTERVAL
    builder.write_sad_file(prefix + ".sad", sa_full[::intv], intv,
                           wide=wide)
    log(f".sad written (intv {intv}, "
        f"{os.path.getsize(prefix + '.sad') / 1e9:.2f} GB)")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], sys.argv[2]))
