"""End-to-end alignment orchestration (reference: Mapping.cpp:579-824).

The per-chunk flow runs the two batched device passes (MEM walks,
locates) for the whole chunk, then per-read host finalization. Chunks
are processed in order, so output is deterministic and matches the
reference at -t 1.
"""

from __future__ import annotations

import os
import sys
import time

from .config import DartConfig
from .constants import VERSION_STR
from .index.loader import Index
from .io.fastx import ChunkReader
from .pipeline.chaining import generate_alignment_candidates
from .pipeline.finalize import gen_mapping_report
from .pipeline.junctions import merge_sj_maps, update_sj_map, write_sj_table
from .pipeline.pairing import (
    check_paired_alignment_candidates,
    check_paired_final_alignments,
    remove_redundant_candidates,
    remove_unmated_candidates,
)
from .pipeline.report import (
    MAX_MAPQ,
    evaluate_mapq,
    output_paired,
    output_single,
    set_paired_alignment_flag,
    set_single_alignment_flag,
)
from .pipeline.seeding import identify_seed_pairs_chunk


# the persistent compile cache lives at one fixed path inside the checkout
# (the path is part of what makes a cached program found again)
CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def _enable_compile_cache():
    """Persist compiled programs across runs. JAX reads
    JAX_COMPILATION_CACHE_DIR itself; only without it is the cache
    pointed at CACHE_DIR."""
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)


def make_engine(idx: Index, cfg: DartConfig):
    engine = cfg.engine
    if engine == "auto":
        # the jax engine serves both the GPU and the CPU backend; numpy
        # is the no-jax fallback
        try:
            import jax  # noqa: F401

            engine = "jax"
        except ImportError:
            engine = "numpy"
    if engine == "jax":
        _enable_compile_cache()
        import jax

        mesh_spec = dict(
            kv.split("=") for kv in cfg.mesh.split(",") if "=" in kv)
        data_n = int(mesh_spec.get("data", 1))
        index_n = int(mesh_spec.get("index", 1))
        if not cfg.silent:
            devs = jax.devices()
            print(f"Compute engine: jax on {devs[0].platform} "
                  f"({devs[0].device_kind}), "
                  f"{max(data_n * index_n, 1)} of {len(devs)} device(s)",
                  file=sys.stderr)
        lut_k = int(os.environ.get("DART_TPU_LUT", "-1"))
        if lut_k < 0:
            # the K-mer jump table (K=11: 4^11 rows, 67 MB) skips the
            # first K-1 backward-search steps of every walk on an
            # accelerator; the CPU backend (tests, dry runs) skips the
            # build cost. K is not yet tuned on the GPU.
            lut_k = 11 if jax.default_backend() != "cpu" else 0
        if idx.seq_len >= 2**31:
            # GRCh38-class genomes: fwd+RC text exceeds int32 — the
            # wide engine runs the same automaton on (lo, hi) uint32
            # pair state (reference: int64 bwt_t, structure.h:29-45)
            from .ops.fm_jax_wide import FMIndexJaxWide

            index_mesh = None
            if index_n > 1 or data_n > 1:
                from .parallel.mesh import make_mesh

                index_mesh = make_mesh(data_n * index_n,
                                       index_shards=index_n)
            return FMIndexJaxWide(idx, max_dup_num=cfg.max_dup_num,
                                  index_mesh=index_mesh, lut_k=lut_k)
        if data_n > 1 or index_n > 1:
            from .parallel.mesh import ShardedFMIndex, make_mesh

            mesh = make_mesh(data_n * index_n, index_shards=index_n)
            return ShardedFMIndex(idx, mesh, max_dup_num=cfg.max_dup_num,
                                  lut_k=lut_k)
        from .ops.fm_jax import FMIndexJax

        return FMIndexJax(idx, max_dup_num=cfg.max_dup_num, lut_k=lut_k)
    from .ops.fm_numpy import FMIndexNumpy

    return _NumpyEngine(FMIndexNumpy(idx), cfg.max_dup_num)


class _NumpyEngine:
    def __init__(self, fm, max_dup_num: int = 100):
        self.fm = fm
        self.max_dup_num = max_dup_num

    def mem_walks(self, chars, valid):
        return self.fm.mem_walk_batch(chars, valid)

    def seed_reads(self, codes, rlens):
        from .pipeline.seeding import seed_reads_from_all_walks

        return seed_reads_from_all_walks(self, codes, rlens, self.max_dup_num)

    def locate(self, rows):
        return self.fm.locate(rows)


class DartAligner:
    def __init__(self, idx: Index, cfg: DartConfig, engine=None):
        self.idx = idx
        self.cfg = cfg
        self.engine = engine if engine is not None else make_engine(idx, cfg)
        self.sj_map: dict = {}
        self.counters = {"total": 0, "unique": 0, "unmapped": 0, "paired": 0}
        self.stats = {"device_seed_locate_s": 0.0, "device_wait_s": 0.0,
                      "native_finalize_s": 0.0, "input_parse_s": 0.0,
                      "output_s": 0.0, "chunks": 0}
        self.native = None
        # -d uses the introspectable single-threaded Python pipeline
        # (the reference forces one thread under -d, Mapping.cpp:757)
        if cfg.native and not cfg.debug:
            try:
                from .pipeline.native_chunk import NativePipeline

                self.native = NativePipeline(idx, cfg)
            except Exception:
                self.native = None

    # ---- per-chunk processing ----

    def process_chunk(self, reads, pair_end: bool, fastq: bool):
        if self.cfg.debug:
            # -d: single-threaded Python pipeline with candidate traces
            # (reference Mapping.cpp:757 forces one thread under -d)
            return self._process_chunk_py(reads, pair_end, fastq)
        if self.native is not None:
            from .pipeline.seeding import seed_occurrence_tables

            occ_off, occ_rpos, occ_len, occ_gpos = seed_occurrence_tables(
                self.engine, reads)
            return self.native.process_chunk(
                reads, pair_end and len(reads) % 2 == 0, fastq,
                occ_off, occ_rpos, occ_len, occ_gpos, self.counters)
        return self._process_chunk_py(reads, pair_end, fastq)

    def _process_chunk_py(self, reads, pair_end: bool, fastq: bool) -> list[str]:
        cfg = self.cfg
        idx = self.idx
        seeds_per_read = identify_seed_pairs_chunk(self.engine, reads, cfg.max_dup_num)
        local_sj: dict = {}
        sam: list[str] = []
        counters = self.counters

        if pair_end and len(reads) % 2 == 0:
            for i in range(0, len(reads), 2):
                r1, r2 = reads[i], reads[i + 1]
                av1 = generate_alignment_candidates(idx, cfg, r1.rlen, seeds_per_read[i])
                av2 = generate_alignment_candidates(idx, cfg, r2.rlen, seeds_per_read[i + 1])
                if check_paired_alignment_candidates(av1, av2):
                    remove_unmated_candidates(av1, av2)
                remove_redundant_candidates(av1)
                remove_redundant_candidates(av2)
                gen_mapping_report(idx, cfg, True, r1, av1)
                gen_mapping_report(idx, cfg, False, r2, av2)
                check_paired_final_alignments(cfg, r1, r2)
                set_paired_alignment_flag(r1, r2)
                evaluate_mapq(r1)
                evaluate_mapq(r2)
                if r1.mapq == MAX_MAPQ or (cfg.find_all_junction and r1.score > 0):
                    update_sj_map(idx, cfg.min_intron_size, av1[r1.best_idx], local_sj)
                if r2.mapq == MAX_MAPQ or (cfg.find_all_junction and r2.score > 0):
                    update_sj_map(idx, cfg.min_intron_size, av2[r2.best_idx], local_sj)
            for i in range(0, len(reads), 2):
                output_paired(cfg, idx.chromosomes, reads[i], reads[i + 1], fastq,
                              counters, sam)
        else:
            keep = []
            for i, read in enumerate(reads):
                av = generate_alignment_candidates(idx, cfg, read.rlen, seeds_per_read[i])
                remove_redundant_candidates(av)
                if cfg.debug:
                    from .pipeline.structs import show_candidate_info

                    show_candidate_info(idx, True, read.header, av)
                gen_mapping_report(idx, cfg, True, read, av)
                set_single_alignment_flag(read)
                evaluate_mapq(read)
                if read.mapq == MAX_MAPQ or (cfg.find_all_junction and read.score > 0):
                    update_sj_map(idx, cfg.min_intron_size, av[read.best_idx], local_sj)
                keep.append(read)
            for read in keep:
                output_single(cfg, idx.chromosomes, read, fastq, counters, sam)

        counters["total"] += len(reads)
        merge_sj_maps(self.sj_map, local_sj)
        return sam

    # ---- full run ----

    def _run_stream_pipelined(self, files, emit) -> None:
        """Overlap the device stages (seeding + locates for chunks
        k+1, k+2) with the native host stages (finalize + output for
        chunk k) and input parsing — the aligner analogue of the
        reference's producer/consumer thread pool (Mapping.cpp:579-681),
        with the device as the producer. TWO chunks stay in flight
        ahead of the one being drained: chunk k+1's first automaton
        round is dispatched before chunk k's results are drained, so
        while the host blocks on chunk k's device-to-host transfers the
        device is already executing k+1's scan — the device stream
        never idles during a drain. (Chunk k's straggler-rerun round
        queues BEHIND k+1's first round, which delays chunk k's own
        completion slightly; that trade assumes the device, not the
        host, sets the pace — wall time then tracks total
        device-stream occupancy, not per-chunk latency.) The
        stream spans ALL -f files (the reference's pool never drains
        between libraries either, main.cpp:142-151). Output order
        stays deterministic.

        files yields per-file state dicts ({reader, pair_end, fastq,
        file_idx, chunks, kind}); emit(sam, fst) writes one chunk."""
        from .pipeline.seeding import finish_chunk, submit_chunk

        state = {"fst": next(files, None)}

        def parse_next():
            t0 = time.time()
            try:
                while state["fst"] is not None:
                    reads = state["fst"]["reader"].next_chunk()
                    if reads:
                        return state["fst"], reads
                    state["fst"]["reader"].close()
                    state["fst"] = next(files, None)
                return None, None
            finally:
                self.stats["input_parse_s"] += time.time() - t0

        def submit(reads):
            t0 = time.time()
            job = submit_chunk(self.engine, reads)
            self.stats["device_seed_locate_s"] += time.time() - t0
            return job

        fst, reads = parse_next()
        job = submit(reads) if reads else None
        pending = None  # the (fst, reads, job) of chunk k+1, in flight
        if reads:
            f2, r2 = parse_next()
            if r2:
                pending = (f2, r2, submit(r2))
        while reads:
            nxt = {}

            def prefetch():
                f3, r3 = parse_next()
                nxt["fst"], nxt["reads"] = f3, r3
                nxt["job"] = submit(r3) if r3 else None

            self._finish_chunk(reads, job, fst["pair_end"], fst["fastq"],
                               lambda sam, _f=fst: emit(sam, _f), prefetch)
            if "reads" not in nxt:  # eager jobs never call the hook
                prefetch()
            if pending is not None:
                fst, reads, job = pending
                pending = ((nxt["fst"], nxt["reads"], nxt["job"])
                           if nxt["reads"] else None)
            else:
                fst, reads, job = nxt["fst"], nxt["reads"], nxt["job"]

    def _finish_chunk(self, reads, job, pair_end: bool, fastq: bool,
                      emit, on_wait=None) -> None:
        from .pipeline.seeding import finish_chunk

        t0 = time.time()
        occ_off, occ_rpos, occ_len, occ_gpos = finish_chunk(
            self.engine, job, on_wait=on_wait)
        self.stats["device_wait_s"] += time.time() - t0
        self.stats["device_seed_locate_s"] += time.time() - t0
        t0 = time.time()
        sam = self.native.process_chunk(
            reads, pair_end and len(reads) % 2 == 0, fastq,
            occ_off, occ_rpos, occ_len, occ_gpos, self.counters)
        self.stats["native_finalize_s"] += time.time() - t0
        t0 = time.time()
        emit(sam)
        self.stats["output_s"] += time.time() - t0
        self.stats["chunks"] += 1

    def header_lines(self) -> list[str]:
        lines = [f"@PG\tID:Dart\tPN:Dart\tVN:{VERSION_STR}"]
        for c in self.idx.chromosomes:
            lines.append(f"@SQ\tSN:{c.name}\tLN:{c.length}")
        return lines

    # ---- checkpoint/resume ----

    def _ckpt_path(self) -> str:
        return self.cfg.output_file + ".ckpt"

    def _merged_sj(self) -> dict:
        """Junction map combining any resumed state (self.sj_map) with
        the native context's accumulation, additively."""
        merged = {k: list(v) for k, v in self.sj_map.items()}
        if self.native is not None:
            for g1, g2, t, c in self.native.sj_items():
                key = (int(g1), int(g2))
                if key in merged:
                    merged[key][1] += int(c)
                else:
                    merged[key] = [int(t), int(c)]
        return merged

    def _reader_kind(self, path1: str, path2) -> str:
        """Which reader class _run would pick for this input — recorded
        in checkpoints because FastChunkReader and ChunkReader cut
        chunk boundaries differently; resuming with a different reader
        would silently duplicate or drop reads."""
        small = os.path.getsize(path1) < (8 << 30)
        if self.native is not None and path2 is None and small:
            return "FastChunkReader"
        if (self.native is not None and path2 is not None and small
                and os.path.getsize(path2) < (8 << 30)):
            return "FastPairedReader"
        return "ChunkReader"

    def _ckpt_save(self, file_idx: int, chunks: int, sam_bytes: int,
                   reader_kind: str) -> None:
        import json

        from .constants import RAMP_READS

        eff_ramp = (RAMP_READS
                    if os.environ.get("DART_TPU_RAMP", "0") == "1" else 0)
        state = {"file_idx": file_idx, "chunks": chunks,
                 "sam_bytes": sam_bytes, "counters": self.counters,
                 "batch_reads": self.cfg.batch_reads,
                 "output_format": self.cfg.output_format,
                 "ramp_reads": eff_ramp,
                 # ramp applies to the first file only; a checkpoint
                 # from the older every-file-ramps layout must not
                 # resume (chunk boundaries in files > 0 moved)
                 "ramp_first_file_only": True,
                 "reader": reader_kind,
                 "sj": [[g1, g2, v[0], v[1]] for (g1, g2), v in
                        sorted(self._merged_sj().items())]}
        tmp = self._ckpt_path() + ".tmp"
        with open(tmp, "w") as f:
            json.dump(state, f)
        os.replace(tmp, self._ckpt_path())

    def _ckpt_load(self):
        import json

        path = self._ckpt_path()
        if not os.path.exists(path):
            return None
        with open(path) as f:
            state = json.load(f)
        from .constants import RAMP_READS

        if state.get("batch_reads") != self.cfg.batch_reads:
            return None  # chunk boundaries would not line up
        eff_ramp = (RAMP_READS
                    if os.environ.get("DART_TPU_RAMP", "0") == "1" else 0)
        if state.get("ramp_reads") != eff_ramp:
            return None  # first-chunk ramp changed: boundaries moved
        if not state.get("ramp_first_file_only"):
            return None  # pre-throttle layout: files > 0 ramped too
        if state.get("output_format", 0) != self.cfg.output_format:
            return None  # SAM checkpoint cannot resume a BAM run etc.
        if not os.path.exists(self.cfg.output_file):
            return None  # partial output vanished: restart cleanly
        fi = state.get("file_idx", 0)
        files2 = (self.cfg.read_files_2 if self.cfg.read_files_2
                  else [None] * len(self.cfg.read_files_1))
        if fi >= len(self.cfg.read_files_1):
            return None
        kind = self._reader_kind(self.cfg.read_files_1[fi], files2[fi])
        if state.get("reader") != kind:
            return None  # different reader = different chunk boundaries
        return state

    def run(self, out_stream=None) -> None:
        cfg = self.cfg
        if cfg.profile_dir:
            import jax

            with jax.profiler.trace(cfg.profile_dir):
                return self._run(out_stream)
        return self._run(out_stream)

    def _run(self, out_stream=None) -> None:
        cfg = self.cfg
        own = False
        writer = None
        resume = None
        if cfg.checkpoint and out_stream is None:
            resume = self._ckpt_load()
        if resume is not None:
            self.counters.update(resume["counters"])
            for g1, g2, t, c in resume["sj"]:
                self.sj_map[(g1, g2)] = [t, c]
            # truncate any partial chunk written after the checkpoint
            # (for BAM the recorded offset is a BGZF block boundary, so
            # truncate + append yields a valid stream)
            with open(cfg.output_file, "r+b") as f:
                f.truncate(resume["sam_bytes"])
            if cfg.output_format == 1:
                from .io.bam import BamWriter

                writer = BamWriter(cfg.output_file, append=True,
                                   threads=cfg.threads,
                                   level=cfg.bam_level)
                writer.write_header(self.header_lines())  # ref map only
            else:
                out_stream = open(cfg.output_file, "ab")
            own = True
        if out_stream is None and writer is None:
            if cfg.output_format == 1:
                from .io.bam import BamWriter

                writer = BamWriter(cfg.output_file,
                                   threads=cfg.threads,
                                   level=cfg.bam_level)
                own = True
            else:
                # binary: the native pipeline emits ready SAM bytes;
                # a text stream would force a decode+encode round trip
                # per chunk
                out_stream = open(cfg.output_file, "wb")
                own = True
        import io as _io

        text_out = out_stream is not None and isinstance(out_stream,
                                                         _io.TextIOBase)
        start = time.time()
        if resume is None:
            header = self.header_lines()
            if writer is not None:
                writer.write_header(header)
            elif text_out:
                for line in header:
                    out_stream.write(line + "\n")
            else:
                out_stream.write("".join(line + "\n" for line in header)
                                 .encode("latin-1"))
        files2 = cfg.read_files_2 if cfg.read_files_2 else [None] * len(cfg.read_files_1)

        def make_reader(file_idx: int, path1: str, path2):
            # inputs of manageable size use the vectorized whole-buffer
            # readers feeding the native pipeline blobs
            small = os.path.getsize(path1) < (8 << 30)
            # the first-chunk ramp (a small first chunk so the device
            # starts after milliseconds of parsing) predates keeping
            # two chunks in flight, where it only adds a full extra
            # round set for a few per cent of the reads, so it is OFF
            # by default. DART_TPU_RAMP=1 re-enables it (e.g. for
            # latency-to-first-output); checkpoints record the
            # effective value and refuse to resume across a change.
            ramp = (file_idx == 0
                    and os.environ.get("DART_TPU_RAMP", "0") == "1")
            if self.native is not None and path2 is None and small:
                from .io.fastx_fast import FastChunkReader

                return FastChunkReader(path1, cfg.pair_end,
                                       cfg.batch_reads, ramp=ramp)
            if (self.native is not None and path2 is not None and small
                    and os.path.getsize(path2) < (8 << 30)):
                from .io.fastx_fast import FastPairedReader

                return FastPairedReader(path1, path2, cfg.batch_reads,
                                        ramp=ramp)
            return ChunkReader(path1, path2, cfg.pair_end,
                               chunk_reads=cfg.batch_reads, ramp=ramp)

        def file_states():
            nonlocal resume
            for file_idx, (path1, path2) in enumerate(
                    zip(cfg.read_files_1, files2)):
                if resume is not None and file_idx < resume["file_idx"]:
                    continue
                reader = make_reader(file_idx, path1, path2)
                chunks_done = 0
                if resume is not None and file_idx == resume["file_idx"]:
                    for _ in range(resume["chunks"]):
                        reader.next_chunk()  # fast-forward (deterministic)
                    chunks_done = resume["chunks"]
                    resume = None
                yield {"file_idx": file_idx, "reader": reader,
                       "chunks": chunks_done, "kind": type(reader).__name__,
                       "pair_end": reader.pair_end, "fastq": reader.fastq}

        ckpt_state = {"t": 0.0}

        def emit(sam, fst):
            if isinstance(sam, bytes):
                if writer is not None:
                    writer.write_sam_bytes(sam)
                elif text_out:
                    out_stream.write(sam.decode("latin-1"))
                else:
                    out_stream.write(sam)
            elif writer is not None:
                for line in sam:
                    writer.write_record(line)
            else:
                text = "\n".join(sam) + ("\n" if sam else "")
                out_stream.write(text if text_out
                                 else text.encode("latin-1"))
            if not cfg.silent:
                print(f"\r{self.counters['total']} "
                      f"{'paired-end' if fst['pair_end'] else 'singled-end'} tags processed "
                      f"in {int(time.time() - start)} seconds...",
                      end="", file=sys.stderr)
            fst["chunks"] += 1
            if cfg.checkpoint and (
                    cfg.ckpt_interval_s <= 0
                    or time.time() - ckpt_state["t"]
                    >= cfg.ckpt_interval_s):
                if writer is not None:
                    off = writer.flush_boundary()
                else:
                    out_stream.flush()
                    off = out_stream.tell()
                self._ckpt_save(fst["file_idx"], fst["chunks"], off,
                                fst["kind"])
                ckpt_state["t"] = time.time()

        if self.native is not None:
            self._run_stream_pipelined(file_states(), emit)
        else:
            for fst in file_states():
                reader = fst["reader"]
                while True:
                    reads = reader.next_chunk()
                    if not reads:
                        break
                    emit(self.process_chunk(reads, fst["pair_end"],
                                            fst["fastq"]), fst)
                reader.close()
        if own:
            if writer is not None:
                writer.close()
            else:
                out_stream.close()
        self.sj_map = self._merged_sj()
        n_sj = write_sj_table(self.idx, self.sj_map, cfg.sj_file)
        if cfg.checkpoint and os.path.exists(self._ckpt_path()):
            os.remove(self._ckpt_path())
        if not cfg.silent:
            print("", file=sys.stderr)
        if cfg.stats:
            wall = time.time() - start
            s = self.stats
            print(f"[stats] wall {wall:.2f}s, {s['chunks']} chunks, "
                  f"{self.counters['total'] / max(wall, 1e-9):.0f} reads/s",
                  file=sys.stderr)
            print(f"[stats] device seed+locate {s['device_seed_locate_s']:.2f}s "
                  f"(stall {s['device_wait_s']:.2f}s) | native finalize "
                  f"{s['native_finalize_s']:.2f}s | input {s['input_parse_s']:.2f}s "
                  f"| output {s['output_s']:.2f}s", file=sys.stderr)
        self.print_summary(n_sj)

    def print_summary(self, n_sj: int) -> None:
        c = self.counters
        total = c["total"]
        if total == 0:
            return

        def pct(x):
            return int(10000 * (x / total) + 0.5) / 100.0

        mapped = total - c["unmapped"]
        out = sys.stdout
        if self.cfg.pair_end or self.cfg.read_files_2:
            print(f"\t# of total mapped reads = {mapped} (sensitivity = {pct(mapped):.2f}%)"
                  f"\n\t# of paired sequences = {c['paired']} ({pct(c['paired']):.2f}%)", file=out)
        else:
            print(f"\t# of total mapped reads = {mapped} (sensitivity = {pct(mapped):.2f}%)", file=out)
        print(f"\t# of unique mapped reads = {c['unique']} ({pct(c['unique']):.2f}%)", file=out)
        if not self.cfg.unique_only:
            multi = mapped - c["unique"]
            print(f"\t# of multiple mapped reads = {multi} ({pct(multi):.2f}%)", file=out)
        print(f"\t# of unmapped reads = {c['unmapped']} ({pct(c['unmapped']):.2f}%)", file=out)
        print(f"\t# of splice junctions = {n_sj} (file: {self.cfg.sj_file})", file=out)
        print(f"\tAlignment output: {self.cfg.output_file}\n", file=out)
