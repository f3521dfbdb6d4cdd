"""Multi-host data-parallel alignment (jax.distributed).

The reference scales with one pthread pool pulling chunks off a global
input lock (Mapping.cpp:16,591-595) — a design that cannot cross hosts.
Here each host owns a byte-range shard of the input (records realigned
at shard boundaries, so no host ever touches another's bytes), aligns
it independently with its local chip(s), and the run ends with two
collectives and a deterministic merge:

- splice-junction tables and summary counters merge across hosts via
  process_allgather (no host-0 bottleneck on the data path);
- each host writes its own SAM shard; host 0 concatenates the shards
  in shard order, so the final file equals a single-host run over the
  same input ordering per shard.

Each process opens one card of its host, its own (card_ids); a host
with fewer cards than processes is refused rather than shared.

Plain (non-gz) FASTA/FASTQ shards by byte range; gzip inputs cannot be
random-accessed, so they shard by round-robin chunk index instead
(every host streams the file but aligns only its own chunks).
"""

from __future__ import annotations

import os

import numpy as np


# ---------------------------------------------------------- input sharding


def find_record_start(fh, offset: int, fastq: bool) -> int:
    """First record boundary at or after `offset`.

    FASTA: a line starting with '>'. FASTQ: a line starting with '@'
    whose next-next line starts with '+' (disambiguates quality lines
    that begin with '@', GetData.cpp-compatible 4-line records)."""
    if offset == 0:
        return 0
    fh.seek(offset)
    fh.readline()  # skip the (possibly partial) current line
    while True:
        pos = fh.tell()
        line = fh.readline()
        if not line:
            return pos
        if not fastq:
            if line.startswith(b">"):
                return pos
            continue
        if line.startswith(b"@"):
            save = fh.tell()
            fh.readline()
            plus = fh.readline()
            fh.seek(save)
            if plus.startswith(b"+"):
                return pos


def byte_shard(path: str, n_shards: int, shard_id: int,
               fastq: bool) -> tuple[int, int]:
    """[start, end) byte range of this host's shard, record-aligned."""
    size = os.path.getsize(path)
    with open(path, "rb") as fh:
        lo = find_record_start(fh, size * shard_id // n_shards, fastq)
        hi = (find_record_start(fh, size * (shard_id + 1) // n_shards, fastq)
              if shard_id + 1 < n_shards else size)
    return lo, hi


class _RangeFile:
    """File object exposing only [start, end) to the line reader."""

    def __init__(self, path: str, start: int, end: int):
        self.fh = open(path, "rb")
        self.fh.seek(start)
        self.end = end

    def readline(self) -> bytes:
        if self.fh.tell() >= self.end:
            return b""
        return self.fh.readline()

    def close(self):
        self.fh.close()


def make_shard_reader(path1: str, path2, pair_end: bool, chunk_reads: int,
                      n_shards: int, shard_id: int):
    """ChunkReader over this host's shard. For paired split files the
    shard boundary must cut both mates at the same RECORD index, so
    split files shard by record-synchronized byte ranges computed from
    mate-1 record counts — conservatively implemented as round-robin
    chunk striping (correct for any input)."""
    from ..io.fastx import ChunkReader

    gz = path1.endswith(".gz")
    if gz or path2 is not None or pair_end:
        # pair_end without path2 = interleaved pairs: byte_shard aligns
        # to ANY record boundary, and a shard starting at an odd record
        # index would flip mate parity for its whole range — chunk
        # round-robin keeps pairs intact (chunks round to even counts)
        return _StridedReader(ChunkReader(path1, path2, pair_end,
                                          chunk_reads=chunk_reads),
                              n_shards, shard_id)
    reader = ChunkReader(path1, None, pair_end, chunk_reads=chunk_reads)
    lo, hi = byte_shard(path1, n_shards, shard_id, reader.fastq)
    reader.r1.fh.close()
    reader.r1.fh = _RangeFile(path1, lo, hi)
    return reader


class _StridedReader:
    """Round-robin chunk assignment over a full-stream reader."""

    def __init__(self, reader, n_shards: int, shard_id: int):
        self.reader = reader
        self.n = n_shards
        self.k = shard_id
        self.i = 0
        self.fastq = reader.fastq
        self.pair_end = reader.pair_end

    def next_chunk(self):
        while True:
            chunk = self.reader.next_chunk()
            if not chunk:
                return chunk
            if self.i % self.n == self.k:
                self.i += 1
                return chunk
            self.i += 1

    def close(self):
        self.reader.close()


# ---------------------------------------------------------- the run


def card_ids(process_id: int, num_processes: int,
             n_cards: int) -> list[int] | None:
    """The card ids process `process_id` opens: its own card, one per
    process. None where the host has no cards (the CPU backend gives
    every process a device of its own). Raises when the host has fewer
    cards than processes, because two processes on one card contend for
    its memory."""
    if n_cards == 0:
        return None
    if n_cards < num_processes:
        raise RuntimeError(
            f"{num_processes} processes need one card each; this host has "
            f"{n_cards}")
    return [process_id]


def host_cards() -> int:
    """NVIDIA cards on this host, or 0 when none is visible or JAX was
    asked for another platform (JAX_PLATFORMS without cuda)."""
    import shutil
    import subprocess

    plats = os.environ.get("JAX_PLATFORMS", "")
    if plats and not any(p in plats for p in ("cuda", "gpu")):
        return 0
    if shutil.which("nvidia-smi") is None:
        return 0
    out = subprocess.run(["nvidia-smi", "-L"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0:
        return 0
    return sum(1 for line in out.stdout.splitlines()
               if line.startswith("GPU "))


def _allgather_sj(sj_items: list) -> dict:
    """Merge per-host junction tables: allgather fixed-size padded
    arrays (jnp collectives need static shapes), then reduce on host."""
    import jax
    from jax.experimental import multihost_utils

    arr = np.asarray(sj_items, dtype=np.int64).reshape(-1, 4)
    n = np.asarray([arr.shape[0]], dtype=np.int32)
    max_n = int(multihost_utils.process_allgather(n).max())
    pad = np.zeros((max_n, 4), dtype=np.int64)
    pad[: arr.shape[0]] = arr
    # ship int64 coordinates as int32 lo/hi pairs: the default JAX
    # config silently downcasts int64 collectives
    all32 = multihost_utils.process_allgather(
        pad.view(np.int32).reshape(max_n, 8) if max_n else
        np.zeros((0, 8), np.int32))
    all_tabs = np.ascontiguousarray(all32).view(np.int64).reshape(
        -1, max_n, 4) if max_n else np.zeros((1, 0, 4), np.int64)
    all_ns = multihost_utils.process_allgather(n)
    merged: dict = {}
    for h in range(all_tabs.shape[0]):
        for g1, g2, t, c in all_tabs[h][: int(all_ns[h][0])]:
            key = (int(g1), int(g2))
            if key in merged:
                merged[key][1] += int(c)
            else:
                merged[key] = [int(t), int(c)]
    return merged


def run_distributed(cfg, coordinator: str, num_processes: int,
                    process_id: int) -> int:
    """Entry point for one host of a multi-host run."""
    import jax

    jax.distributed.initialize(
        coordinator_address=coordinator, num_processes=num_processes,
        process_id=process_id,
        local_device_ids=card_ids(process_id, num_processes, host_cards()))
    if jax.process_count() != num_processes:
        # some backends register distributed state without actually
        # forming the process group; running on would silently drop
        # every other host's output at the merge
        raise RuntimeError(
            f"jax.distributed formed {jax.process_count()} processes, "
            f"expected {num_processes}; this backend cannot run "
            "multi-process")
    from jax.experimental import multihost_utils

    from ..aligner import DartAligner
    from ..index import load_index
    from ..pipeline.junctions import write_sj_table

    idx = load_index(cfg.index_prefix)
    aligner = DartAligner(idx, cfg)

    import json

    shard_sam = f"{cfg.output_file}.shard{process_id:04d}"
    files2 = cfg.read_files_2 if cfg.read_files_2 else [None] * len(cfg.read_files_1)
    # per-file chunk byte ranges: round-robin (strided) shards must be
    # re-interleaved in global chunk order at the merge, and multi-file
    # runs must merge file sections in input order — a plain shard-file
    # concatenation would reorder both
    shard_meta = {"files": []}

    # per-host checkpoint (survey §5): each host persists its own input
    # cursor (file section + chunk count), shard byte offset, partial
    # junction table and counters; a restarted job resumes every shard
    # from its last completed chunk
    ckpt_path = shard_sam + ".ckpt"
    resume = None
    if cfg.checkpoint and os.path.exists(ckpt_path) \
            and os.path.exists(shard_sam):
        with open(ckpt_path) as f:
            st = json.load(f)
        if (st.get("batch_reads") == cfg.batch_reads
                and st.get("nprocs") == num_processes):
            resume = st
            aligner.counters.update(resume["counters"])
            for g1, g2, t, cnt in resume["sj"]:
                aligner.sj_map[(g1, g2)] = [t, cnt]
            with open(shard_sam, "r+") as f:
                f.truncate(resume["bytes"])
            shard_meta["files"] = resume["files_done"]

    with open(shard_sam, "a" if resume else "w") as out:
        state = {"fi": 0, "chunks": 0}

        def emit(sam):
            out.write(sam.decode("latin-1") if isinstance(sam, bytes)
                      else "\n".join(sam) + ("\n" if sam else ""))
            offs.append(out.tell())
            state["chunks"] += 1
            if cfg.checkpoint:
                out.flush()
                tmp = ckpt_path + ".tmp"
                with open(tmp, "w") as f:
                    json.dump({
                        "batch_reads": cfg.batch_reads,
                        "nprocs": num_processes,
                        "file_idx": state["fi"],
                        "chunks": state["chunks"],
                        "bytes": out.tell(),
                        "offs": offs,
                        "files_done": shard_meta["files"],
                        "counters": aligner.counters,
                        "sj": [[g1, g2, v[0], v[1]] for (g1, g2), v in
                               sorted(aligner._merged_sj().items())]}, f)
                os.replace(tmp, ckpt_path)
                crash_after = int(os.environ.get(
                    "DART_TPU_TEST_CRASH_AFTER_CHUNKS", "0"))
                if crash_after and state["chunks"] >= crash_after:
                    # test hook: simulate a host failure after N chunks
                    raise RuntimeError("injected distributed crash")

        for fi, (path1, path2) in enumerate(zip(cfg.read_files_1, files2)):
            if resume is not None and fi < resume["file_idx"]:
                continue
            reader = make_shard_reader(path1, path2, cfg.pair_end,
                                       cfg.batch_reads, num_processes,
                                       process_id)
            state["fi"] = fi
            state["chunks"] = 0
            offs = [out.tell()]
            if resume is not None and fi == resume["file_idx"]:
                for _ in range(resume["chunks"]):
                    reader.next_chunk()  # deterministic fast-forward
                state["chunks"] = resume["chunks"]
                offs = resume["offs"]
                resume = None
            if aligner.native is not None:
                fst = {"file_idx": fi, "reader": reader, "chunks": 0,
                       "kind": type(reader).__name__,
                       "pair_end": reader.pair_end, "fastq": reader.fastq}
                aligner._run_stream_pipelined(iter([fst]),
                                              lambda sam, _f: emit(sam))
            else:
                while True:
                    reads = reader.next_chunk()
                    if not reads:
                        break
                    emit(aligner.process_chunk(reads, reader.pair_end,
                                               reader.fastq))
            reader.close()
            shard_meta["files"].append(
                {"strided": isinstance(reader, _StridedReader),
                 "offsets": offs})

    with open(shard_sam + ".idx", "w") as f:
        json.dump(shard_meta, f)
    if cfg.checkpoint and os.path.exists(ckpt_path):
        os.remove(ckpt_path)

    # ---- merge phase (collectives) ----
    # _merged_sj combines resumed state with the native accumulation
    sj_items = [(g1, g2, v[0], v[1]) for (g1, g2), v in
                sorted(aligner._merged_sj().items())]
    merged_sj = _allgather_sj(sj_items)
    c = aligner.counters
    local = np.asarray([c["total"], c["unique"], c["unmapped"], c["paired"]],
                       dtype=np.int64)
    totals = multihost_utils.process_allgather(local).sum(axis=0)

    if process_id == 0:
        aligner.sj_map = merged_sj
        aligner.native = None  # totals only from the merged map below
        c["total"], c["unique"], c["unmapped"], c["paired"] = (
            int(totals[0]), int(totals[1]), int(totals[2]), int(totals[3]))
        # The strided re-interleave below maps chunk j to
        # shards[j % n] by POSITION, so a missing shard (or missing
        # .idx meta) would silently reorder/drop records — refuse to
        # merge instead. Shards land on other hosts' local disks when
        # there is no shared filesystem; in that case gather the
        # .shard*/.idx files onto host 0 and rerun, or concatenate
        # them manually (order across shards is then undefined).
        shards = []
        missing = []
        for pid in range(num_processes):
            shard = f"{cfg.output_file}.shard{pid:04d}"
            if not (os.path.exists(shard) and os.path.exists(shard + ".idx")):
                missing.append(shard)
                continue
            with open(shard + ".idx") as f:
                meta = json.load(f)
            shards.append((open(shard, "rb"), meta))
        if missing:
            raise RuntimeError(
                "cannot merge output shards: missing shard files or "
                ".idx metadata on host 0 (no shared filesystem?): "
                + ", ".join(missing))

        def merged_pieces():
            """Yield shard byte ranges in single-host output order:
            file sections in input order; within a strided file, chunks
            re-interleaved round-robin (chunk j came from shard
            j % n_shards at local index j // n_shards); byte-range
            files in shard order."""
            n_files = max((len(m["files"]) for _, m in shards if m),
                          default=0)
            for fi in range(n_files):
                strided = any(m["files"][fi]["strided"]
                              for _, m in shards if m)
                if strided:
                    j = 0
                    while True:
                        fh, m = shards[j % len(shards)]
                        offs = m["files"][fi]["offsets"]
                        k = j // len(shards)
                        if k + 1 >= len(offs):
                            break  # first missing chunk ends the file
                        yield fh, offs[k], offs[k + 1]
                        j += 1
                else:
                    for fh, m in shards:
                        offs = m["files"][fi]["offsets"]
                        yield fh, offs[0], offs[-1]

        if cfg.output_format == 1:
            # -bo: shards are SAM text; host 0 encodes the merge to BAM
            from ..io.bam import BamWriter

            writer = BamWriter(cfg.output_file, threads=cfg.threads,
                               level=cfg.bam_level)
            writer.write_header(aligner.header_lines())
            for fh, lo, hi in merged_pieces():
                fh.seek(lo)
                for line in fh.read(hi - lo).decode("latin-1").splitlines():
                    if line:
                        writer.write_record(line)
            writer.close()
        else:
            with open(cfg.output_file, "wb") as final:
                for line in aligner.header_lines():
                    final.write(line.encode() + b"\n")
                for fh, lo, hi in merged_pieces():
                    fh.seek(lo)
                    left = hi - lo
                    while left > 0:
                        buf = fh.read(min(left, 1 << 20))
                        if not buf:
                            break
                        final.write(buf)
                        left -= len(buf)
        for fh, _ in shards:
            fh.close()
        n_sj = write_sj_table(idx, merged_sj, cfg.sj_file)
        aligner.print_summary(n_sj)
    multihost_utils.sync_global_devices("dart_tpu_run_done")
    return 0
