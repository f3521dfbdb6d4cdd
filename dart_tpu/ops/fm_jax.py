"""JAX/XLA FM-index engine: batched MEM walks and SA locates on device.

Design:
- The FM-index lives in device memory as a blocked layout: one uint32
  row of 8 words per 64 BWT bases — [occ_A, occ_C, occ_G, occ_T, w0,
  w1, w2, w3] — so each Occ query is one aligned 32-byte row gather
  plus in-register popcounts (the reference's __occ_aux bit trick,
  bwt_search.cpp:34-41, widened to 32-bit lanes).
- Each loop iteration performs exactly ONE row gather (the two Occ
  queries of a backward-search step are batched into a single 2R-row
  gather) and everything else is flat (R,)-shaped elementwise work:
  4-wide even-bit SWAR popcounts, select trees instead of tiny-table
  gathers, one-hot reductions instead of cross-lane take_along_axis
  for per-lane read characters. (This shape was tuned on an earlier
  accelerator; it has not been re-tuned for the GPU.)
- Every (read, start-position) MEM task is one lane of a masked
  fixed-trip scan; every SA locate is one lane of a masked LF-walk
  while_loop. No data-dependent control flow — everything
  jit-compiles to static shapes.
- Row indices are int32: genomes up to 2^31 bases of fwd+RC text
  (~1 Gbp genome) per shard. Larger genomes shard the index over a
  mesh axis (see dart_tpu.parallel).

Results are bit-identical to ops/fm_numpy.FMIndexNumpy (tested).
"""

from __future__ import annotations

import functools
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from ..index import layout_cache
from ..index.loader import Index

BLOCK = 64  # bases per occ-checkpoint row

_TRACE = bool(os.environ.get("DART_TPU_TRACE_ROUNDS"))


def _tr(tag: str) -> None:
    """Round timeline tracing (DART_TPU_TRACE_ROUNDS=1): one stderr
    line per submit/block/unblock event, for localizing how much of
    device_wait_s is per-round latency vs compute."""
    if _TRACE:
        print(f"[rt {time.monotonic():.3f}] {tag}", file=sys.stderr,
              flush=True)


def build_device_layout(idx: Index):
    """Pack the host index into the (n_blocks, 8) uint32 device layout."""
    if idx.seq_len >= 2**31:
        raise ValueError("single-shard FM layout requires seq_len < 2^31")
    n = idx.seq_len
    n_blocks = (n + BLOCK - 1) // BLOCK
    padded = np.zeros(n_blocks * BLOCK, dtype=np.uint8)
    padded[:n] = idx.bwt
    # occ at block starts
    onehot = padded.reshape(n_blocks, BLOCK, 1) == np.arange(4, dtype=np.uint8)
    per_block = onehot.sum(axis=1).astype(np.int64)
    occ_start = np.zeros((n_blocks, 4), dtype=np.int64)
    np.cumsum(per_block[:-1], axis=0, out=occ_start[1:])
    # pack 16 bases/word, first base in top bits
    w = padded.reshape(-1, 16).astype(np.uint32)
    shifts = np.arange(15, -1, -1, dtype=np.uint32) * 2
    words = (w << shifts).sum(axis=1, dtype=np.uint64).astype(np.uint32).reshape(n_blocks, 4)
    blocks = np.concatenate([occ_start.astype(np.uint32), words], axis=1)
    return blocks


def build_merged_table(idx: Index, blocks: np.ndarray,
                       samples_np: np.ndarray, index_shards: int = 1):
    """Append the fast-extension regions to the block table as extra
    8-word rows — the 2-bit packed genome (16 bases/word, top-first)
    and the SA samples — so every automaton mode is served by ONE row
    gather from ONE table. Returns (merged, ref_off, sad_off).
    Shared by the engine and the driver entry harness."""
    n_blocks = blocks.shape[0]
    seq_len = int(idx.seq_len)
    n_words = (seq_len + 15) // 16
    n_wrows = -(-n_words // 8) + 1  # +1: compare may read row+1
    codes16 = np.zeros((n_wrows * 8 * 16,), dtype=np.uint32)
    codes16[:seq_len] = np.minimum(idx.ref_codes, 3)
    w = codes16.reshape(-1, 16)
    shifts = np.arange(15, -1, -1, dtype=np.uint64) * 2
    ref_rows = (w.astype(np.uint64) << shifts).sum(
        axis=1, dtype=np.uint64).astype(np.uint32).reshape(n_wrows, 8)
    n_srows = -(-samples_np.shape[0] // 8)
    sad_rows = np.zeros((n_srows * 8,), dtype=np.int32)
    sad_rows[: samples_np.shape[0]] = samples_np
    sad_rows = sad_rows.view(np.uint32).reshape(n_srows, 8)
    ref_off = n_blocks
    sad_off = n_blocks + n_wrows
    merged = np.concatenate([blocks, ref_rows, sad_rows])
    if index_shards > 1 and merged.shape[0] % index_shards:
        # pad to a shard-divisible row count (pad rows are never
        # gathered; offsets precede the padding)
        merged = np.concatenate(
            [merged, np.zeros(((-merged.shape[0]) % index_shards, 8),
                              np.uint32)])
    return merged, ref_off, sad_off


def _lut_extend(blocks, L2, x0, x1, x2, *, primary):
    """One LUT-build level: extend every parent walk state by each of
    the 4 bases (children interleaved: child[4i+c] = extend(parent i, c)).
    Dead parents (x2 == 0) stay dead."""
    alive = x2 > 0
    q1 = jnp.where(alive, x1 - 1, 0)
    q2 = jnp.where(alive, x1 - 1 + x2, 0)
    tk, tl = _occ4_pair(blocks, q1, q2, primary)
    starts, nx1, w = _backward_ext_state(L2, x0, x1, x2, tk, tl, primary)
    cx0 = jnp.stack([starts[3 - c] for c in range(4)], axis=1)
    cx1 = jnp.stack([nx1[3 - c] for c in range(4)], axis=1)
    cw = jnp.stack([w[3 - c] for c in range(4)], axis=1)
    ok = alive[:, None] & (cw > 0)
    n4 = 4 * x0.shape[0]
    return (jnp.where(ok, cx0, 0).reshape(n4),
            jnp.where(ok, cx1, 0).reshape(n4),
            jnp.where(ok, cw, 0).reshape(n4))


def build_lut(blocks, L2, primary: int, K: int):
    """Build the K-mer walk-state LUT on device: for every K-mer (key =
    base-4 big-endian), the bidirectional interval (x0, x1, x2) after
    the forward-MEM walk (BWT_Search init + K-1 extensions) consumes its
    K characters, or x2 == 0 if the walk dies earlier. The seeding
    automaton uses it to start each walk K characters in — walks that
    die before K can only yield seeds shorter than MIN_SEED_LEN, whose
    only effect is advancing the scan by one, so a dead entry IS the
    answer. Returns (4^K, 4) uint32 rows [x0, x1, x2, 0]."""
    c = jnp.arange(4, dtype=jnp.int32)
    x0 = L2[c] + 1
    x1 = L2[3 - c] + 1
    x2 = L2[c + 1] - L2[c]
    ext = jax.jit(functools.partial(_lut_extend, primary=primary))
    for _ in range(K - 1):
        x0, x1, x2 = ext(blocks, L2, x0, x1, x2)
    zero = jnp.zeros_like(x0)
    return jax.jit(lambda a, b, d: jnp.stack(
        [a, b, d, zero], axis=1).astype(jnp.uint32))(x0, x1, x2)


class FMIndexJax:
    """Single-chip engine; pass data_mesh (a Mesh with a "data" axis)
    to run the same programs data-parallel over every chip in the mesh
    with the index tables replicated (GSPMD partitions the automaton's
    while_loop cleanly: all per-lane state is batch-sharded, the only
    cross-lane ops are gathers from replicated tables)."""

    def __init__(self, idx: Index, device=None, max_dup_num: int = 100,
                 lut_k: int = 0, data_mesh=None):
        index_shards = 1
        tab_device = device
        self._walk_sh = {}
        if data_mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            device = NamedSharding(data_mesh, P())
            rep = NamedSharding(data_mesh, P())
            d2 = NamedSharding(data_mesh, P("data", None))
            d1 = NamedSharding(data_mesh, P("data"))
            # an "index" mesh axis range-shards the merged gather table
            # (and the dense SA samples) across chips; XLA GSPMD
            # partitions every row gather with collectives, so the SAME
            # automaton programs serve genomes too big for one device — no
            # separate slow path
            index_shards = int(dict(data_mesh.shape).get("index", 1))
            tab_device = (NamedSharding(data_mesh, P("index", None))
                          if index_shards > 1 else rep)
            self._seed_sh = dict(in_shardings=(tab_device, rep, rep, d2),
                                 out_shardings=d2)
            self._loc_sh = dict(in_shardings=(tab_device, rep, d1),
                                out_shardings=d1)
            self._walk_sh = dict(in_shardings=(tab_device, rep, d2, d2),
                                 out_shardings=(d1, d1, d1))
            self._min_bucket = max(1024, 128 * data_mesh.devices.size)
        else:
            self._seed_sh = {}
            self._loc_sh = {}
            self._min_bucket = 1024
        self._index_shards = index_shards
        self.L2 = jax.device_put(idx.L2.astype(np.int32), device)
        # dense samples (builder .sad, sad_intv > 0): shorter LF-walks
        # on device. The samples ride ONLY as sad rows of the merged
        # table below (locate reads them through the same gather path);
        # a separate device copy would double SA-sample memory
        self.sa_intv = int(idx.sad_intv) if idx.sad_intv else int(idx.sa_intv)
        self.primary = int(idx.primary)
        self.seq_len = int(idx.seq_len)
        self.max_dup_num = int(max_dup_num)
        self.lut_k = int(lut_k)
        self._lut = None  # built lazily on first seed_reads
        self.lut_off = 0
        # fast-extension path: append to the block table (as extra
        # 8-word rows) the 2-bit packed genome (16 bases/word,
        # top-first) and the SA samples, so every automaton mode is
        # served by ONE row gather from ONE table. Big indexes memmap
        # the merged table from the disk-backed layout cache —
        # file-backed faults dodge this host's anon-fault collapse
        merged = None
        cache_meta = {"seq_len": self.seq_len, "sa_intv": self.sa_intv}
        use_cache = (index_shards == 1 and getattr(idx, "prefix", None)
                     and layout_cache.eligible(self.seq_len))
        if use_cache:
            merged, h = layout_cache.load_array(idx.prefix, "ntab",
                                                cache_meta)
            if merged is not None:
                self.ref_off, self.sad_off = int(h["ref_off"]), int(h["sad_off"])
        if merged is None:
            blocks = build_device_layout(idx)
            samples_np = (idx.sad_samples if idx.sad_intv
                          else idx.sa_samples).astype(np.int32)
            merged, self.ref_off, self.sad_off = build_merged_table(
                idx, blocks, samples_np, index_shards)
            if use_cache:
                layout_cache.save_array(
                    idx.prefix, "ntab", merged,
                    dict(cache_meta, ref_off=self.ref_off,
                         sad_off=self.sad_off))
        self.table = jax.device_put(merged, tab_device)
        # every kernel indexes only rows < its own region's bound, so
        # the merged table serves as the plain block table too
        self.blocks = self.table
        self._walk_jit = jax.jit(functools.partial(
            _mem_walks_kernel, primary=self.primary), **self._walk_sh)
        self._locate_jit = {}
        self._seed_jit = {}
        # tiny locate batches skip the device round trip: with the
        # fast-extension path nearly every occurrence is located
        # in-kernel (fewer than 10 SA-locate rows per 65k-read chunk
        # on the bench mix), so a device locate round would be mostly
        # dispatch and transfer latency for a handful of rows — a
        # vectorized host LF-walk over the same index answers them,
        # bit-equal (ops/fm_numpy.locate is the tested oracle). Capped
        # to <=2^28 texts so the pinned host arrays stay <~400 MB.
        self._host_fm = None
        if self.seq_len <= (1 << 28):
            try:
                from .fm_numpy import FMIndexNumpy

                self._host_fm = FMIndexNumpy(idx, lean=True)
            except Exception:
                self._host_fm = None

    def seed_reads(self, codes: np.ndarray, rlens: np.ndarray):
        """Batched reference seeding scan (IdentifySeedPairs jump
        semantics) as a device automaton: one lane per read. Returns
        (n_seeds (R,), rpos/length/k0/freq (R, S)) int32/int64.

        Transfer-minimal: each call moves ONE 2-bit-packed code buffer
        up and ONE packed result buffer down (half-word-packed columns
        when lengths permit), so a round pays one transfer each way. The rare straggler reads (repetitive-
        sequence scans are O(len^2)) that exhaust the iteration cap are
        re-run from scratch in a fixed smaller bucket with a cap
        covering the worst case — recompute beats shipping resume
        state, and the closed shape set keeps the compiled-program set
        small enough for warmup to cover entirely.
        """
        R, L = codes.shape
        if L >= 65536:
            raise ValueError("reads must be shorter than 65536 bases")
        Lp = max(32, -(-L // 32) * 32)
        words = Lp // 16
        Rp = self._pad_up(R, self._min_bucket)
        rl = np.zeros(Rp, dtype=np.int32)
        rl[:R] = np.asarray(rlens, dtype=np.int32)
        # 2-bit pack (16 codes per uint32, top-first) + an N-exception
        # bitmask covering ambiguous bases within each read (positions
        # past rlen pack as code 3 with no mask bit — every kernel read
        # there is rlen-guarded); same contract as native dart_pack_reads
        cp = np.full((Rp, Lp), 4, dtype=np.uint8)
        cp[:R, :L] = codes
        in_read = np.arange(Lp, dtype=np.int32)[None, :] < rl[:, None]
        c2 = np.where(in_read, np.minimum(cp, 3), 3).astype(np.uint32)
        buf = np.zeros((Rp, words + 1), dtype=np.uint32)
        nmask = np.zeros((Rp, words // 2), dtype=np.uint32)
        for k in range(16):
            buf[:, :words] |= c2[:, k::16] << np.uint32(2 * (15 - k))
        buf[:, words] = rl.view(np.uint32)
        isn = (cp > 3) & in_read
        has_n = isn.any(axis=1)
        if has_n.any():
            for k in range(32):
                nmask |= isn[:, k::32].astype(np.uint32) << np.uint32(31 - k)
        return self.seed_finish(self.seed_submit_packed(
            buf, nmask, has_n.astype(np.uint8), int(has_n.sum()), R, Lp,
            int(rl[:R].max()) if R else 1))

    @staticmethod
    def seed_slots(Lp: int, max_rlen: int) -> int:
        """Worst-case seed-slot count: every accepted seed advances the
        scan by >= MIN_SEED_LEN(16) from a position < rlen - 13, so a
        read of max_rlen yields at most (max_rlen - 14)//16 + 1 seeds.
        Rounded up to even (the half-word result packing pairs slots)
        — a much tighter result-transfer width than the Lp//16 worst
        case."""
        s = max(1, (max_rlen - 14) // 16 + 1)
        return min(Lp // 16, s + (s & 1))

    @staticmethod
    def seed_slots_r1(s_full: int) -> int:
        """Round-1 slot count: the DOMINANT downlink cost is the
        (R, 1 + S/2 + S + S/2) result buffer, and measured seed counts
        are far below the worst case (100 bp bench mix incl. 30%
        spliced: p99.9 = 4 seeds vs the cap of 6), so round 1 ships a
        slimmer table and the rare lane that accepts more seeds than
        fits is simply reported not-done — it reroutes through the
        straggler rerun round, which always carries the full-width
        cap. Even (half-word packing pairs slots)."""
        return min(s_full, max(4, (s_full // 2 + 1) & ~1))

    def seed_submit_packed(self, buf, nmask, has_n, n_with_n: int,
                           nlive: int, Lp: int, max_rlen: int):
        """Dispatch the first (full-width) seed-scan round without
        syncing, so the caller can overlap the device pass with host
        work on other chunks.

        buf is the single merged transfer buffer (Rp, Lp/16 + 1):
        [2-bit packed codes | rlen], padded to a power-of-two row
        bucket — ONE host->device array per round (each array pays its
        own transfer latency). The N-exception mask stays on
        the host: ambiguous bases are rare in real data, so reads
        containing any (has_n, count n_with_n) are simply marked live
        after round 1 — their round-1 results are valid for the
        N->code-3 substituted read, i.e. wrong, and are discarded —
        and rerouted through the straggler rerun round, whose merged
        buffer carries the mask columns inline. Only when a chunk is
        mask-HEAVY does round 1 ship the mask inline instead."""
        Rp = buf.shape[0]
        S = self.seed_slots(Lp, max_rlen)
        S1 = self.seed_slots_r1(S)
        words = Lp // 16
        masked = n_with_n > max(1024, nlive // 16)
        if masked:
            buf = np.concatenate(
                [buf[:, :words], nmask, buf[:, words:]], axis=1)
        # round-1 iteration cap (see the wide engine's T1 note): the
        # whole batch pays the cap while only stragglers profit
        T1 = int(os.environ.get("DART_TPU_T1", "128"))
        dev = self.submit_seed_round(buf, Rp, Lp, T1, S1,
                                     use_nmask=masked)
        return {"dev": dev, "buf": buf, "nmask": None if masked else nmask,
                "has_n": None if masked or not n_with_n else has_n,
                "masked": masked, "nlive": nlive, "Lp": Lp, "S": S,
                "S1": S1}

    def seed_drain(self, job):
        """Drain the submitted rounds one at a time: yields
        (lane_ids, n, rpos, len, k0, freq) for the lanes that COMPLETED
        in each round (lane_ids ascending), having already dispatched
        the next straggler round before yielding — so the caller can
        overlap its per-part host work (occurrence expansion, locate
        dispatch) with the rerun executing on the device.

        Straggler policy: lanes that exhaust the iteration cap
        (repetitive-sequence scans are O(len^2)) are re-run from
        scratch in fixed smaller buckets with a worst-case cap —
        recompute beats shipping resume state, and the closed shape set
        keeps the compiled-program set small enough for warmup to
        cover. Rerun buffers ALWAYS carry the mask columns inline
        ([packed | nmask | rlen]): one program variant, and masked
        rows are exactly why rerouted N-reads land here."""
        buf, nmask, has_n = job["buf"], job["nmask"], job["has_n"]
        Lp, S = job["Lp"], job["S"]
        words = Lp // 16
        lane_ids = np.arange(job["nlive"], dtype=np.int64)
        first_Rp = buf.shape[0]
        # rerun cap covers the closed-form worst case: a scan that
        # restarts at every position and extends to the read end costs
        # (L+1)(L+2)/2 steps (loops exit early when done, so oversizing
        # only costs masked device iterations on the rare rerun path)
        T_rerun = max(2048, (Lp + 1) * (Lp + 2) // 2)
        dev = job["dev"]
        rounds = 0
        while lane_ids.size:
            rounds += 1
            if rounds > 4:
                raise RuntimeError("seed scan failed to converge")
            # round 1 ships the slim S1-slot result (seed_slots_r1);
            # every rerun round carries the full worst-case width
            S_r = job["S1"] if rounds == 1 else S
            packed_halves = (Lp < 256 and self.max_dup_num <= 32766
                             and S_r % 2 == 0)
            nlive = lane_ids.size
            _tr(f"seed drain r{rounds} block (nlive={nlive})")
            host = np.asarray(dev)[:nlive]  # one d2h
            _tr(f"seed drain r{rounds} done")
            done = (host[:, 0] & 1) != 0
            if rounds == 1 and has_n is not None:
                # N-containing reads ran round 1 with their ambiguous
                # bases substituted (mask not shipped): discard those
                # results and reroute the reads to the masked rerun
                done &= has_n[lane_ids] == 0
            fin = np.nonzero(done)[0]
            ids = lane_ids[fin]
            live = np.nonzero(~done)[0]
            if live.size:
                lane_ids = lane_ids[live]
                Rp = min(self._pad_up(lane_ids.size, self._min_bucket),
                         first_Rp)
                rb = np.zeros((Rp, words + words // 2 + 1),
                              dtype=np.uint32)
                if job["masked"]:
                    rb[:lane_ids.size] = buf[lane_ids]
                else:
                    rb[:lane_ids.size, :words] = buf[lane_ids, :words]
                    rb[:lane_ids.size, words:words + words // 2] = \
                        nmask[lane_ids]
                    rb[:lane_ids.size, -1] = buf[lane_ids, words]
                dev = self.submit_seed_round(rb, Rp, Lp, T_rerun, S,
                                             use_nmask=True)
            rp, ln, kk, fr = _unpack_seed_host(host, fin, S_r,
                                               packed_halves)
            yield (ids, (host[fin, 0] >> 1).astype(np.int32), rp, ln,
                   kk.astype(np.int64), fr)
            if not live.size:
                return

    def seed_finish(self, job, on_wait=None):
        """Drain every round into full (R, S) seed tables. Returns
        (n_seeds (R,), rpos/length/k0/freq (R, S)). on_wait, if given,
        fires once when the final results are in."""
        R, S = job["nlive"], job["S"]
        n_out = np.zeros(R, dtype=np.int32)
        rpos_out = np.zeros((R, S), dtype=np.int32)
        len_out = np.zeros((R, S), dtype=np.int32)
        k0_out = np.zeros((R, S), dtype=np.int64)
        freq_out = np.zeros((R, S), dtype=np.int32)
        for ids, nn, rp, ln, kk, fr in self.seed_drain(job):
            w = rp.shape[1]  # round 1 yields the slim S1 width
            n_out[ids] = nn
            rpos_out[ids, :w] = rp
            len_out[ids, :w] = ln
            k0_out[ids, :w] = kk
            freq_out[ids, :w] = fr
        if on_wait is not None:
            on_wait()
        return n_out, rpos_out, len_out, k0_out, freq_out

    def submit_seed_round(self, buf, Rp, Lp, T, S=None, use_nmask=False):
        """Dispatch one seed-scan program without syncing (an async
        device round). buf is the single merged transfer buffer:
        [packed codes | nmask columns if use_nmask | rlen] — ONE
        host->device array. S is the seed-slot count (default: the
        Lp-derived worst case; callers pass the tighter max-rlen bound
        to shrink the result transfer). Returns the device array."""
        if S is None:
            S = Lp // 16
        if self.lut_k and self._lut is None:
            # the LUT stays a SEPARATE table: folding its 4^K rows into
            # the block table makes every gather pay large-table rates;
            # instead init states are pre-gathered once per chunk
            # inside the kernel
            self._lut = build_lut(self.table, self.L2, self.primary,
                                  self.lut_k)
        key = (Rp, Lp, T, use_nmask, S)
        if key not in self._seed_jit:
            self._seed_jit[key] = jax.jit(functools.partial(
                _seed_scan_packed, primary=self.primary,
                max_dup=self.max_dup_num, max_seeds=S, max_iters=T,
                read_len=Lp, lut_k=self.lut_k,
                ref_off=self.ref_off, sad_off=self.sad_off,
                sa_intv=self.sa_intv, seq_len=self.seq_len,
                use_nmask=use_nmask),
                **self._seed_sh)
        _tr(f"seed submit Rp={Rp} T={T} ({buf.nbytes >> 10} KiB up)")
        return self._seed_jit[key](self.table, self.L2, self._lut,
                                   jnp.asarray(buf))

    @staticmethod
    def _pad_up(n: int, floor: int = 4096) -> int:
        """Next bucket (>= floor) from the closed shape set
        {2^k} U {3*2^k}: powers of two plus midpoints. The midpoints
        matter for trailing chunks — 100k reads split 65536 + 34464,
        and padding the tail to 65536 wastes 31% of its round's
        gathers and transfer; 49152 wastes 12%. Still a small closed
        set, so the compiled-program count stays warm-coverable."""
        p = floor
        while p < n:
            if (mid := p + (p >> 1)) >= n:
                return mid
            p <<= 1
        return p

    def mem_walks(self, chars: np.ndarray, valid: np.ndarray):
        W, L = chars.shape
        # pad batch and length to buckets to bound jit recompilation
        Wp = self._pad_up(W)
        Lp = max(8, -(-L // 32) * 32)
        cp = np.full((Wp, Lp), 4, dtype=np.uint8)
        vp = np.zeros((Wp, Lp), dtype=bool)
        cp[:W, :L] = chars
        vp[:W, :L] = valid
        lens, x0, x2 = self._walk_jit(self.blocks, self.L2,
                                      jnp.asarray(cp), jnp.asarray(vp))
        return (np.asarray(lens[:W], dtype=np.int64),
                np.asarray(x0[:W], dtype=np.int64),
                np.asarray(x2[:W], dtype=np.int64))

    def _locate_round(self, cur_k: np.ndarray, T: int):
        """Dispatch one locate program (no sync); returns the device
        array. Batch pads to the power-of-two bucket set."""
        npad = self._pad_up(cur_k.size, self._min_bucket)
        kp = np.zeros(npad, dtype=np.int32)
        kp[: cur_k.size] = cur_k
        key = (npad, T)
        if key not in self._locate_jit:
            self._locate_jit[key] = jax.jit(functools.partial(
                _locate_packed, primary=self.primary,
                sa_intv=self.sa_intv, sad_off=self.sad_off,
                max_iters=T), **self._loc_sh)
        _tr(f"locate submit n={cur_k.size} pad={npad} T={T}")
        return self._locate_jit[key](self.blocks, self.L2, jnp.asarray(kp))

    def locate_submit(self, rows: np.ndarray):
        """Dispatch the first locate round without syncing, so the
        caller can enqueue more device work (e.g. the next chunk's
        seed round) behind it before blocking."""
        n = rows.shape[0]
        if n == 0:
            return None
        if n <= 512 and self._host_fm is not None:
            _tr(f"locate host n={n}")
            return {"host": self._host_fm.locate(
                np.asarray(rows, dtype=np.int64)).astype(np.int64)}
        cur_k = np.asarray(rows, dtype=np.int32)
        # walk lengths are geometric(1/intv): cap at intv*(ln n + 4) so
        # the expected straggler count is ~0 and one round suffices;
        # derived from the PADDED size so shapes stay deterministic
        T = int(self.sa_intv * (np.log(self._pad_up(n, self._min_bucket)) + 4.0)
                / 32 + 1) * 32
        return {"dev": self._locate_round(cur_k, T), "k": cur_k, "n": n}

    def locate_finish(self, job) -> np.ndarray:
        """Drain a locate_submit job with straggler compaction:
        LF-walk length is geometric with mean sa_intv/2 but its max
        over a large batch is ~sa_intv*ln(batch); unfinished lanes are
        compacted to smaller power-of-two batches and rerun with a
        larger cap rather than holding the full batch width for the
        tail."""
        if job is None:
            return np.empty(0, dtype=np.int64)
        if "host" in job:
            return job["host"]
        n = job["n"]
        out = np.zeros(n, dtype=np.int64)
        lane_ids = np.arange(n, dtype=np.int64)
        cur_k = job["k"]
        dev = job["dev"]
        while lane_ids.size:
            _tr(f"locate drain block (n={lane_ids.size})")
            loc = np.asarray(dev)[: lane_ids.size]  # one transfer
            _tr("locate drain done")
            fin = loc != _LOCATE_UNFINISHED
            out[lane_ids[fin]] = loc[fin]
            live = ~fin
            if not live.any():
                break
            # stragglers: rerun from the original row with a larger cap
            # (deterministic straggler-round shape)
            lane_ids = lane_ids[live]
            cur_k = cur_k[live]
            dev = self._locate_round(cur_k, 512 * self.sa_intv)
        return out

    def locate(self, rows: np.ndarray) -> np.ndarray:
        """Batched SA lookups (submit + drain in one call)."""
        return self.locate_finish(self.locate_submit(rows))


def _unpack_seed_host(host, fin, S, packed_halves):
    """Decode the packed seed-result buffer rows `fin` into
    (rpos, len, k0, freq) int32 matrices (see _seed_scan_packed for the
    layout). All field extractions mask after shifting: host is int32,
    so a bare `>> 16` would sign-extend for rpos >= 32768 (reads are
    accepted up to 65535 bases)."""
    if packed_halves:
        H = S // 2
        meta2 = host[fin, 1:1 + H]
        meta = np.empty((fin.shape[0], S), np.int32)
        meta[:, 0::2] = (meta2 >> 16) & 0xFFFF
        meta[:, 1::2] = meta2 & 0xFFFF
        rp = meta >> 8
        ln = meta & 0xFF
        kk = host[fin, 1 + H:1 + H + S]
        fr2 = host[fin, 1 + H + S:1 + H + S + H]
        fr = np.empty((fin.shape[0], S), np.int32)
        fr[:, 0::2] = (fr2 >> 16) & 0xFFFF
        fr[:, 1::2] = fr2 & 0xFFFF
        return rp, ln, kk, fr - 1
    meta = host[fin, 1:1 + S]
    return ((meta >> 16) & 0xFFFF, meta & 0xFFFF,
            host[fin, 1 + S:1 + 2 * S], host[fin, 1 + 2 * S:1 + 3 * S])


# ---------------- kernels (pure jax; jitted above) ----------------
#
# Shared conventions: every per-lane value is a flat (N,) int32/uint32
# vector; the only gathers are block-row fetches from the (n_blocks, 8)
# table, merged so each loop iteration issues exactly one gather op.


def _pc_even(y):
    """Popcount of a uint32 whose set bits sit on even positions."""
    y2 = (y + (y >> 2)) & jnp.uint32(0x33333333)
    y3 = (y2 + (y2 >> 4)) & jnp.uint32(0x0F0F0F0F)
    return ((y3 * jnp.uint32(0x01010101)) >> 24).astype(jnp.int32)


def _sel4(c, v0, v1, v2, v3):
    """Per-lane 4-way select by c in 0..3 (cheaper than a tiny gather)."""
    lo = jnp.where((c & 1) != 0, v1, v0)
    hi = jnp.where((c & 1) != 0, v3, v2)
    return jnp.where((c & 2) != 0, hi, lo)


def _l2_lookup(L2, c):
    """L2[c] for per-lane c in 0..4 as a select tree."""
    r = jnp.where(c == 0, L2[0], L2[4])
    for i in (1, 2, 3):
        r = jnp.where(c == i, L2[i], r)
    return r


def _word_masks(take):
    """Masks keeping the first `take` (1..64) bases of a 4-word group,
    top bits first."""
    ms = []
    for j in range(4):
        tw = jnp.clip(take - j * 16, 0, 16)
        shift = jnp.minimum((16 - tw) * 2, 31)
        m = jnp.where(tw == 0, jnp.uint32(0),
                      jnp.uint32(0xFFFFFFFF) << shift.astype(jnp.uint32))
        ms.append(m)
    return ms


def _occ4_cols(cols, kk):
    """Occ(kk, c) for all c given the 8 gathered row columns.
    kk (N,) int32 >= 0 (already primary-adjusted). Returns 4 x (N,)."""
    take = (kk & 63) + 1
    masks = _word_masks(take)
    wms = [cols[4 + j] & masks[j] for j in range(4)]
    pad = 64 - take
    out = []
    for c in range(4):
        cnt = jnp.zeros_like(kk)
        for wm in wms:
            hi = wm if (c & 2) else ~wm
            lo = wm if (c & 1) else ~wm
            cnt = cnt + _pc_even((hi >> 1) & lo & jnp.uint32(0x55555555))
        if c == 0:
            cnt = cnt - pad  # masked-off bases read as base 0
        out.append(cols[c].astype(jnp.int32) + cnt)
    return out


def _occ4_pair(blocks, k1, k2, primary):
    """Occ4 at two positions with ONE merged row gather
    (bwt_2occ4 semantics, bwt_search.cpp:86-125).
    Returns (tk[0..3], tl[0..3]) as 8 (N,) int32 vectors."""
    n = k1.shape[0]
    kk1 = jnp.maximum(k1 - (k1 >= primary).astype(jnp.int32), 0)
    kk2 = jnp.maximum(k2 - (k2 >= primary).astype(jnp.int32), 0)
    kk = jnp.concatenate([kk1, kk2])
    rows = blocks[kk >> 6]                      # (2N, 8) single gather
    cols = [rows[:, j] for j in range(8)]
    occ = _occ4_cols(cols, kk)
    zero1 = (k1 == -1)
    zero2 = (k2 == -1)
    tk = [jnp.where(zero1, 0, o[:n]) for o in occ]
    tl = [jnp.where(zero2, 0, o[n:]) for o in occ]
    return tk, tl


def _backward_ext_state(L2, x0, x1, x2, tk, tl, primary):
    """Shared bidirectional-interval update: given occ4 results at
    x1-1 / x1-1+x2, produce per-base candidate (start, new_x1, width)
    select inputs (BWT_Search extension, bwt_search.cpp:150-171)."""
    w = [tl[c] - tk[c] for c in range(4)]
    adj = ((x1 <= primary) & (x1 + x2 - 1 >= primary)).astype(jnp.int32)
    s3 = x0 + adj
    s2 = s3 + w[3]
    s1 = s2 + w[2]
    s0 = s1 + w[1]
    starts = (s0, s1, s2, s3)
    nx1 = tuple(L2[c] + 1 + tk[c] for c in range(4))
    return starts, nx1, w


def _mem_walks_kernel(blocks, L2, chars, valid, *, primary):
    """Batched forward-MEM walks (BWT_Search semantics). chars (W, L)
    uint8; returns (lens, x0, x2) int32. Characters stream through the
    scan as xs — no per-lane char gathers."""
    c0 = jnp.minimum(chars[:, 0].astype(jnp.int32), 3)
    x0 = _l2_lookup(L2, c0) + 1
    x1 = _l2_lookup(L2, 3 - c0) + 1
    x2 = _l2_lookup(L2, c0 + 1) - _l2_lookup(L2, c0)
    started = valid[:, 0] & (chars[:, 0] <= 3)
    lens = jnp.where(started, 1, 0).astype(jnp.int32)

    def step(carry, inp):
        x0, x1, x2, lens, active = carry
        ch, ok = inp
        ch = ch.astype(jnp.int32)
        live = active & ok & (ch <= 3)
        tk, tl = _occ4_pair(blocks, x1 - 1, x1 - 1 + x2, primary)
        starts, nx1, w = _backward_ext_state(L2, x0, x1, x2, tk, tl, primary)
        ci = 3 - jnp.minimum(ch, 3)
        wi = _sel4(ci, *w)
        upd = live & (wi > 0)
        x0 = jnp.where(upd, _sel4(ci, *starts), x0)
        x1 = jnp.where(upd, _sel4(ci, *nx1), x1)
        x2 = jnp.where(upd, wi, x2)
        lens = jnp.where(upd, lens + 1, lens)
        return (x0, x1, x2, lens, upd), None

    init = (x0, x1, x2, lens, started)
    (x0, x1, x2, lens, _), _ = jax.lax.scan(
        step, init, (chars[:, 1:].T, valid[:, 1:].T))
    return lens, x0, x2


def round_inputs(buf, read_len, use_nmask):
    """Split one seed round's merged transfer buffer [packed codes |
    N-mask columns iff use_nmask | rlen] into the kernel's inputs:
    (code words + pad column, N-mask words + pad column, rlens). The
    kernel reads characters, K-mer keys, and genome-compare words
    straight from the 2-bit packed words (the pad column serves
    cross-word windows) — no (R, L) unpacked codes matrix exists
    anywhere: per-iteration character reads are (R, Lw+1)-wide selects
    instead of (R, L) one-hot reductions."""
    R = buf.shape[0]
    words = read_len // 16
    rlens = jax.lax.bitcast_convert_type(buf[:, -1], jnp.int32)
    pad = jnp.zeros((R, 1), jnp.uint32)
    wcols = jnp.concatenate([buf[:, :words], pad], axis=1)
    if use_nmask:
        nmask1 = jnp.concatenate(
            [buf[:, words:words + words // 2], pad], axis=1)
    else:
        nmask1 = jnp.zeros((R, words // 2 + 1), jnp.uint32)
    return wcols, nmask1, rlens


def _seed_scan_packed(table, L2, lut, buf, *, primary,
                      max_dup, max_seeds, max_iters, read_len, lut_k=0,
                      ref_off=0, sad_off=0, sa_intv=0, seq_len=0,
                      use_nmask=True):
    """Transfer-minimal wrapper: ONE merged uint32 input buffer
    [2-bit packed codes (16/word, top-first) | N-exception bitmask
    columns iff use_nmask | rlen] — each host->device array pays its
    own transfer latency, so everything crosses in a single one —
    and the result leaves as one packed int32 buffer —
    [done|nseeds<<1, (rpos, len) x S, k0_or_gpos x S, freq x S]
    (freq == -1 marks a direct seed whose k0 slot holds the genome
    position itself; see the fast-extension path). The mask is omitted
    for rounds whose reads are all unambiguous: positions past rlen
    are rlen-guarded in the kernel, so the mask only matters for
    genuinely ambiguous bases (rare; rerouted to masked rerun rounds)."""
    S = max_seeds
    wcols, nmask1, rlens = round_inputs(buf, read_len, use_nmask)
    st = _seed_scan_kernel(table, L2, wcols, nmask1, rlens,
                           primary=primary,
                           max_dup=max_dup, max_seeds=S, max_iters=max_iters,
                           lut=lut, lut_k=lut_k, ref_off=ref_off,
                           sad_off=sad_off, sa_intv=sa_intv, seq_len=seq_len)
    (done, nseeds, o_rpos, o_len, o_k0, o_freq, _) = st
    # a lane that accepted more seeds than this round's slot count
    # holds truncated results: report it not-done so the host reroutes
    # it through the (full-width) straggler rerun round
    done = done & (nseeds <= S)
    head = (done.astype(jnp.int32) | (nseeds << 1))[:, None]
    if read_len < 256 and max_dup <= 32766 and S % 2 == 0:
        # half-word packing: (rpos, len) byte pairs and freq+1 uint16
        # pairs — half the result bytes to move
        meta = (o_rpos << 8) | o_len                      # (S, R), 16 bits
        meta2 = (meta[0::2] << 16) | meta[1::2]           # (S/2, R)
        fr = (o_freq + 1).astype(jnp.int32)               # -1 -> 0
        fr2 = (fr[0::2] << 16) | fr[1::2]                 # (S/2, R)
        cols = [head, meta2.T, o_k0.T, fr2.T]
    else:
        cols = [head, ((o_rpos << 16) | o_len).T, o_k0.T, o_freq.T]
    return jnp.concatenate(cols, axis=1)


def _sel8(i, cols):
    """Per-lane 8-way select by i in 0..7 from 8 column vectors."""
    lo = _sel4(i & 3, cols[0], cols[1], cols[2], cols[3])
    hi = _sel4(i & 3, cols[4], cols[5], cols[6], cols[7])
    return jnp.where(i >= 4, hi, lo)


def _clz32(v):
    """Count leading zeros of a uint32 (bit-smear + full popcount)."""
    v = v | (v >> 1)
    v = v | (v >> 2)
    v = v | (v >> 4)
    v = v | (v >> 8)
    v = v | (v >> 16)
    v = v - ((v >> 1) & jnp.uint32(0x55555555))
    v = (v & jnp.uint32(0x33333333)) + ((v >> 2) & jnp.uint32(0x33333333))
    v = (v + (v >> 4)) & jnp.uint32(0x0F0F0F0F)
    return (32 - ((v * jnp.uint32(0x01010101)) >> 24)).astype(jnp.int32)


def _expand16(x):
    """Morton-expand the low 16 bits of a uint32 to even bit positions
    (bit j -> bit 2j): turns the 1-bit-per-position N-exception mask
    into the 2-bit-per-base layout of the packed code words."""
    x = x & jnp.uint32(0xFFFF)
    x = (x | (x << 8)) & jnp.uint32(0x00FF00FF)
    x = (x | (x << 4)) & jnp.uint32(0x0F0F0F0F)
    x = (x | (x << 2)) & jnp.uint32(0x33333333)
    x = (x | (x << 1)) & jnp.uint32(0x55555555)
    return x


def _seed_scan_kernel(table, L2, words, nmask1, rlens, *, primary, max_dup,
                      max_seeds, max_iters, lut=None, lut_k=0,
                      ref_off=0, sad_off=0, sa_intv=0, seq_len=0):
    """Device automaton replaying the reference seeding scan
    (IdentifySeedPairs, AlignmentCandidates.cpp:188-211): one lane per
    read; each iteration either (re)initializes the bidirectional
    interval at the current scan position or advances its walk. Accepted
    MEMs (len >= 16, occ <= max_dup) are emitted and the scan jumps past
    them; otherwise it advances by one. Seed emission into the (S, R)
    output slabs happens at most once per lane per iteration and is
    gated behind a lax.cond.

    With a K-mer LUT (build_lut), the init step consumes K characters in
    one iteration: alive K-mers jump straight to the stored interval;
    dead ones (absent from the genome, or an ambiguous base in the
    window) advance the scan by one — identical outcomes to walking,
    since any walk that dies before K < MIN_SEED_LEN is a rejected seed.

    With ref_off/sad_off (the fast-extension path), a walk whose
    interval narrows to a single occurrence (x2 == 1) leaves backward
    search: the lane LF-walks to the occurrence's text position (mode
    LOCATE) and then finishes the maximal exact match by comparing the
    read against the genome 16 bases per iteration (mode COMPARE) —
    equivalent by uniqueness: with one occurrence left, the pattern
    extends exactly while the text at that occurrence matches. Such
    seeds are emitted with freq == -1 and the genome position directly
    in the k0 slot, which also removes them from the SA-locate pass.
    The packed genome words and SA samples live as extra 8-word rows of
    the same table (at ref_off/sad_off), so every mode's memory access
    is the SAME single 2R-row gather.

    Returns (done, nseeds, rpos, len, k0, freq, iterations run).
    """
    R = words.shape[0]
    Lw = words.shape[1] - 1           # packed words per read (+1 pad)
    L = Lw * 16
    Wn = nmask1.shape[1] - 1          # 1-bit N-mask words (+1 pad)
    S = max_seeds
    fast = ref_off > 0 and sa_intv > 0
    use_lut = lut is not None and lut_k > 0
    # LUT read strategy: pre-gather the walk state for EVERY position
    # once (R*L rows) and read per-iteration states with (R, L)
    # one-hot reductions, instead of a per-iteration R-row gather
    # from the 4^K-row table inside the while_loop
    # (DART_TPU_LUT_PRE=0). Which one wins on the GPU is not measured.
    lut_pre = os.environ.get("DART_TPU_LUT_PRE", "1") != "0"
    rwords = words                    # same 2-bit top-first packing
    iota_w = jax.lax.broadcasted_iota(jnp.int32, (1, Lw + 1), 1)
    iota_n = jax.lax.broadcasted_iota(jnp.int32, (1, Wn + 1), 1)
    if use_lut and lut_pre:
        # per-position K-mer windows assembled from the packed words
        # (no unpacked codes matrix): win[:, p] = 32-bit code window
        # at p; key = its top 2K bits; bad = any N bit in the window
        w1 = words[:, :Lw]
        w2 = words[:, 1:Lw + 1]
        win_cols = []
        for k in range(16):
            sh = jnp.uint32(2 * k)
            win_cols.append(w1 if k == 0 else
                            (w1 << sh) | (w2 >> (jnp.uint32(32) - sh)))
        win = jnp.stack(win_cols, axis=2).reshape(R, L)
        keyp = (win >> jnp.uint32(32 - 2 * lut_k)).astype(jnp.int32)
        n1 = nmask1[:, :Wn]
        n2 = nmask1[:, 1:Wn + 1]
        nwin_cols = []
        for k in range(32):
            sh = jnp.uint32(k)
            nwin_cols.append(n1 if k == 0 else
                             (n1 << sh) | (n2 >> (jnp.uint32(32) - sh)))
        nwin = jnp.stack(nwin_cols, axis=2).reshape(R, L)
        badp = (nwin >> jnp.uint32(32 - lut_k)) != 0
        iota_l = jax.lax.broadcasted_iota(jnp.int32, (1, L), 1)
        badp = badp | (iota_l + lut_k > rlens[:, None])
        pre = lut[jnp.where(badp, 0, keyp).reshape(-1)].reshape(R, L, 4)
        li_x0 = pre[..., 0].astype(jnp.int32)
        li_x1 = pre[..., 1].astype(jnp.int32)
        li_x2 = jnp.where(badp, 0, pre[..., 2].astype(jnp.int32))
    if fast:
        # the genome-compare step forces mismatches at N positions via
        # a 2-bit mask in code-word layout; expand the 1-bit transfer
        # mask once (zeros when the round shipped no mask)
        nw_cols = []
        for c in range(Lw // 2):
            m = nmask1[:, c]
            for half in (m >> jnp.uint32(16), m & jnp.uint32(0xFFFF)):
                e = _expand16(half)
                nw_cols.append(e | (e << 1))
        nw_cols.append(jnp.zeros((R,), jnp.uint32))
        nwords = jnp.stack(nw_cols, axis=1)  # (R, Lw + 1)

    end_pos = jnp.maximum(rlens - 13, 0)
    pos = jnp.zeros(R, jnp.int32)
    cur = jnp.zeros(R, jnp.int32)  # cur == pos -> not initialized
    x0 = jnp.zeros(R, jnp.int32)
    x1 = jnp.zeros(R, jnp.int32)
    x2 = jnp.zeros(R, jnp.int32)
    nseeds = jnp.zeros(R, jnp.int32)
    mode = jnp.zeros(R, jnp.int32)   # 0 scan, 1 locate, 2 compare
    lk = jnp.zeros(R, jnp.int32)     # LOCATE: current row
    steps = jnp.zeros(R, jnp.int32)  # LOCATE: LF steps taken
    gbase = jnp.zeros(R, jnp.int32)  # COMPARE: occurrence pos - pos
    done = pos >= end_pos
    out_rpos = jnp.zeros((S, R), jnp.int32)
    out_len = jnp.zeros((S, R), jnp.int32)
    out_k0 = jnp.zeros((S, R), jnp.int32)
    out_freq = jnp.zeros((S, R), jnp.int32)
    slot_ids = jax.lax.broadcasted_iota(jnp.int32, (S, 1), 0)

    def cond(st):
        return jnp.any(~st[0][0]) & (st[1] < max_iters)

    def body(outer_st):
        st, it = outer_st
        (done, pos, cur, x0, x1, x2, nseeds, mode, lk, steps, gbase,
         out_rpos, out_len, out_k0, out_freq) = st

        initing = (~done) & (cur == pos)
        working = (~done) & (cur > pos)
        scanning = working & (mode == 0)
        if fast:
            # a fresh x2==1 lane starts its LF walk THIS iteration
            to_loc = scanning & (x2 == 1) & (cur < rlens)
            scanning = scanning & ~to_loc
            locating = (working & (mode == 1)) | to_loc
            comparing = working & (mode == 2)
            lk_eff = jnp.where(to_loc, x0, lk)
            steps_eff = jnp.where(to_loc, 0, steps)
        else:
            to_loc = jnp.zeros_like(scanning)
            locating = to_loc
            comparing = to_loc
            lk_eff = lk
            steps_eff = steps

        # per-lane character read straight from the packed words: a
        # (R, Lw+1)-wide select + shift instead of an (R, L) one-hot
        # reduction (L = 8-40x wider than Lw+1); initing lanes have
        # cur == pos, so charat(cur) == charat(pos) (and keyat likewise)
        safe_cur = jnp.minimum(cur, L - 1)
        qw_i = safe_cur >> 4
        ohw_i = iota_w == qw_i[:, None]
        rw_i = jnp.sum(jnp.where(ohw_i, rwords, 0), axis=1)
        sh_i = ((~safe_cur & 15) << 1).astype(jnp.uint32)
        ch2 = ((rw_i >> sh_i) & 3).astype(jnp.int32)
        qn_i = safe_cur >> 5
        ohn_i = iota_n == qn_i[:, None]
        nm_i = jnp.sum(jnp.where(ohn_i, nmask1, 0), axis=1)
        nbit = ((nm_i >> (31 - (safe_cur & 31)).astype(jnp.uint32))
                & 1) != 0
        amb = (cur >= rlens) | nbit
        ch = jnp.where(amb, 4, ch2)
        c_safe = jnp.minimum(ch, 3)

        # ---- init values ----
        if use_lut and lut_pre:
            oh_l = iota_l == safe_cur[:, None]
            i_x0 = jnp.sum(jnp.where(oh_l, li_x0, 0), axis=1)
            i_x1 = jnp.sum(jnp.where(oh_l, li_x1, 0), axis=1)
            i_x2 = jnp.sum(jnp.where(oh_l, li_x2, 0), axis=1)
            init_ok = i_x2 > 0
            init_jump = lut_k
        elif use_lut:
            # K-mer key = the top 2K bits of the 32-bit code window at
            # cur (packing is top-first), assembled from two adjacent
            # words; the LUT state is ONE R-row gather per iteration.
            # Ambiguous windows are dead (badN from the 1-bit mask);
            # init positions satisfy cur <= rlen-14 < rlen-K, so the
            # window never crosses the read end.
            w2_i = jnp.sum(jnp.where(iota_w == (qw_i + 1)[:, None],
                                     rwords, 0), axis=1)
            boff = ((safe_cur & 15) << 1).astype(jnp.uint32)
            win = jnp.where(boff == 0, rw_i,
                            (rw_i << boff)
                            | (w2_i >> (jnp.uint32(32) - boff)))
            key = (win >> jnp.uint32(32 - 2 * lut_k)).astype(jnp.int32)
            nm2_i = jnp.sum(jnp.where(iota_n == (qn_i + 1)[:, None],
                                      nmask1, 0), axis=1)
            nb = (safe_cur & 31).astype(jnp.uint32)
            nwin = jnp.where(nb == 0, nm_i,
                             (nm_i << nb)
                             | (nm2_i >> (jnp.uint32(32) - nb)))
            badN = (nwin >> jnp.uint32(32 - lut_k)) != 0
            bad = badN | (cur + lut_k > rlens)
            lrow = lut[jnp.where(initing & ~bad, key, 0)]
            i_x0 = lrow[:, 0].astype(jnp.int32)
            i_x1 = lrow[:, 1].astype(jnp.int32)
            i_x2 = jnp.where(bad, 0, lrow[:, 2].astype(jnp.int32))
            init_ok = i_x2 > 0
            init_jump = lut_k
        else:
            i_x0 = _l2_lookup(L2, c_safe) + 1
            i_x1 = _l2_lookup(L2, 3 - c_safe) + 1
            i_x2 = _l2_lookup(L2, c_safe + 1) - _l2_lookup(L2, c_safe)
            init_ok = ~amb
            init_jump = 1

        # ---- THE gather: one 2R-row fetch serves every mode + init ----
        q1 = jnp.where(scanning, x1 - 1, jnp.where(locating, lk_eff, 0))
        q2 = jnp.where(scanning, x1 - 1 + x2, 0)
        kkA = jnp.maximum(q1 - (q1 >= primary).astype(jnp.int32), 0)
        kkB = jnp.maximum(q2 - (q2 >= primary).astype(jnp.int32), 0)
        rowA = kkA >> 6
        rowB = kkB >> 6
        if fast:
            loc_hit = locating & ((lk_eff % sa_intv) == 0)
            goff = gbase + cur
            gsafe = jnp.where(comparing, goff, 0)
            rowA = jnp.where(comparing, ref_off + (gsafe >> 7),
                             jnp.where(loc_hit,
                                       sad_off + ((lk_eff // sa_intv) >> 3),
                                       rowA))
            rowB = jnp.where(comparing, ref_off + (gsafe >> 7) + 1, rowB)
        else:
            loc_hit = to_loc
        rows = table[jnp.concatenate([rowA, rowB])]  # (2R, 8), one gather
        colsA = [rows[:R, j] for j in range(8)]
        colsB = [rows[R:, j] for j in range(8)]
        occA = _occ4_cols(colsA, kkA)            # tk (scan) / occ (locate)
        occB = _occ4_cols(colsB, kkB)            # tl (scan)

        # ---- scan step ----
        starts, nx1, w = _backward_ext_state(L2, x0, x1, x2, occA, occB,
                                             primary)
        ci = 3 - c_safe
        wi = _sel4(ci, *w)
        can_extend = scanning & ~amb & (wi > 0)
        scan_end = scanning & ~can_extend

        if fast:
            # ---- locate step (bwt_sa LF walk, one row already fetched) ----
            loc_step = locating & ~loc_hit
            xx = lk_eff - (lk_eff > primary).astype(jnp.int32)
            word = _sel4((xx >> 4) & 3, colsA[4], colsA[5], colsA[6], colsA[7])
            cbit = ((word >> ((~xx & 15) << 1).astype(jnp.uint32)) & 3).astype(jnp.int32)
            occ_c = _sel4(cbit, *occA)
            lk_next = jnp.where(lk_eff == primary, 0,
                                _l2_lookup(L2, cbit) + occ_c)
            # sad value: extract from this lane's (sad) row
            sad_val = jax.lax.bitcast_convert_type(
                _sel8((lk_eff // sa_intv) & 7, colsA), jnp.int32)
            g_abs = steps_eff + sad_val          # occurrence text position

            # ---- compare step: 16 bases per iteration ----
            jword = (gsafe >> 4) & 7
            gw1 = _sel8(jword, colsA)
            gw2 = jnp.where(jword < 7, _sel8(jword + 1, colsA), colsB[0])
            aoff = ((gsafe & 15) << 1).astype(jnp.uint32)
            gw = jnp.where(aoff == 0, gw1,
                           (gw1 << aoff) | (gw2 >> (jnp.uint32(32) - aoff)))
            qw = cur >> 4
            ohw = iota_w == jnp.minimum(qw, Lw)[:, None]
            ohw2 = iota_w == jnp.minimum(qw + 1, Lw)[:, None]
            rw1 = jnp.sum(jnp.where(ohw, rwords, 0), axis=1)
            rw2 = jnp.sum(jnp.where(ohw2, rwords, 0), axis=1)
            nm1 = jnp.sum(jnp.where(ohw, nwords, 0), axis=1)
            nm2 = jnp.sum(jnp.where(ohw2, nwords, 0), axis=1)
            boff = ((cur & 15) << 1).astype(jnp.uint32)
            rw = jnp.where(boff == 0, rw1,
                           (rw1 << boff) | (rw2 >> (jnp.uint32(32) - boff)))
            nm = jnp.where(boff == 0, nm1,
                           (nm1 << boff) | (nm2 >> (jnp.uint32(32) - boff)))
            v = (gw ^ rw) | nm
            matched16 = jnp.where(v == 0, 16, _clz32(v) >> 1)
            avail = jnp.minimum(jnp.minimum(16, rlens - cur),
                                seq_len - goff)
            matched = jnp.minimum(matched16, jnp.maximum(avail, 0))
            cur_c = cur + jnp.where(comparing, matched, 0)
            cmp_end = comparing & ((matched < 16) | (cur_c >= rlens) |
                                   (gbase + cur_c >= seq_len))
        else:
            loc_step = to_loc
            lk_next = lk
            g_abs = steps
            cur_c = cur
            cmp_end = to_loc

        # ---- seed end: accept/emit/jump ----
        any_end = scan_end | cmp_end
        length = jnp.where(cmp_end, cur_c, cur) - pos
        acc_scan = scan_end & (x2 <= max_dup) & (length >= 16)
        acc_cmp = cmp_end & (length >= 16)       # unique: freq 1 <= max_dup
        acc = acc_scan | acc_cmp
        k0_val = jnp.where(cmp_end, gbase + pos, x0)
        fr_val = jnp.where(cmp_end, -1, x2)

        def emit(args):
            o_rpos, o_len, o_k0, o_freq = args
            hit = acc[None, :] & (slot_ids == nseeds[None, :])  # (S, R)
            return (jnp.where(hit, pos[None, :], o_rpos),
                    jnp.where(hit, length[None, :], o_len),
                    jnp.where(hit, k0_val[None, :], o_k0),
                    jnp.where(hit, fr_val[None, :], o_freq))

        out_rpos, out_len, out_k0, out_freq = jax.lax.cond(
            jnp.any(acc), emit, lambda a: a,
            (out_rpos, out_len, out_k0, out_freq))
        nseeds = jnp.where(acc, nseeds + 1, nseeds)

        # ---- state update ----
        new_pos = jnp.where(any_end, jnp.where(acc, pos + length, pos + 1),
                            jnp.where(initing & ~init_ok, pos + 1, pos))
        new_cur = jnp.where(can_extend, cur + 1,
                            jnp.where(initing & init_ok, cur + init_jump,
                            jnp.where(comparing & ~cmp_end, cur_c,
                            jnp.where(locating, cur, new_pos))))
        x0n = jnp.where(can_extend, _sel4(ci, *starts),
                        jnp.where(initing & init_ok, i_x0, x0))
        x1n = jnp.where(can_extend, _sel4(ci, *nx1),
                        jnp.where(initing & init_ok, i_x1, x1))
        x2n = jnp.where(can_extend, wi,
                        jnp.where(initing & init_ok, i_x2, x2))
        if fast:
            mode_n = jnp.where(loc_hit & locating, 2,
                               jnp.where(to_loc, 1,
                                         jnp.where(any_end, 0, mode)))
            lk_n = jnp.where(locating,
                             jnp.where(loc_step, lk_next, lk_eff), lk)
            steps_n = jnp.where(locating,
                                jnp.where(loc_step, steps_eff + 1, steps_eff),
                                steps)
            gbase_n = jnp.where(loc_hit & locating, g_abs - pos, gbase)
        else:
            mode_n, lk_n, steps_n, gbase_n = mode, lk, steps, gbase
        done = done | (new_pos >= end_pos)
        return ((done, new_pos, new_cur, x0n, x1n, x2n, nseeds,
                 mode_n, lk_n, steps_n, gbase_n,
                 out_rpos, out_len, out_k0, out_freq), it + 1)

    st = (done, pos, cur, x0, x1, x2, nseeds, mode, lk, steps, gbase,
          out_rpos, out_len, out_k0, out_freq)
    st, iters = jax.lax.while_loop(cond, body, (st, jnp.int32(0)))
    (done, _, _, _, _, _, nseeds, _, _, _, _,
     out_rpos, out_len, out_k0, out_freq) = st
    return done, nseeds, out_rpos, out_len, out_k0, out_freq, iters


_LOCATE_UNFINISHED = -(2**31)


def _locate_packed(blocks, L2, k, *, primary, sa_intv, sad_off, max_iters):
    """Transfer-minimal wrapper for _locate_kernel: ONE (N,) int32 out;
    lanes that exhausted the iteration cap carry the sentinel and are
    re-run from scratch by the host. Locations fit int32 (device
    layouts require seq_len < 2^31)."""
    steps = jnp.zeros_like(k)
    k2, _, loc = _locate_kernel(blocks, L2, k, steps,
                                primary=primary, sa_intv=sa_intv,
                                sad_off=sad_off, max_iters=max_iters)
    finished = (k2 & (sa_intv - 1)) == 0
    return jnp.where(finished, loc.astype(jnp.int32),
                     jnp.int32(_LOCATE_UNFINISHED))


def _locate_kernel(blocks, L2, k, steps, *, primary, sa_intv, sad_off,
                   max_iters):
    """Batched bwt_sa: LF-walk each row until it hits a sampled row
    (row index % intv == 0), then add the sample
    (bwt_search.cpp:127-137). One merged row gather per iteration
    serves both the BWT character read and the Occ count; the final
    sample is read from the table's own sad region (8 samples per
    8-word row at sad_off), so no separate sample array rides in
    device memory.
    Bounded at max_iters; returns (k, steps, locations) for host-side
    resume."""
    mask = sa_intv - 1

    def cond(carry):
        k, _, it = carry
        return jnp.any((k & mask) != 0) & (it < max_iters)

    def body(carry):
        k, steps, it = carry
        active = (k & mask) != 0
        kk = jnp.maximum(k - (k >= primary).astype(jnp.int32), 0)
        x = k - (k > primary).astype(jnp.int32)
        # x>>6 == kk>>6 except at k == primary, whose result is
        # overridden below — one gather serves char and occ
        rows = blocks[kk >> 6]
        cols = [rows[:, j] for j in range(8)]
        word = _sel4((x >> 4) & 3, cols[4], cols[5], cols[6], cols[7])
        shift = ((~x & 15) << 1).astype(jnp.uint32)
        c = ((word >> shift) & 3).astype(jnp.int32)
        # occ(k, c) for the per-lane c
        take = (kk & 63) + 1
        masks = _word_masks(take)
        cnt = jnp.zeros_like(k)
        for j in range(4):
            wm = cols[4 + j] & masks[j]
            hi = jnp.where((c & 2) != 0, wm, ~wm)
            lo = jnp.where((c & 1) != 0, wm, ~wm)
            cnt = cnt + _pc_even((hi >> 1) & lo & jnp.uint32(0x55555555))
        cnt = jnp.where(c == 0, cnt - (64 - take), cnt)
        base = _sel4(c, cols[0].astype(jnp.int32), cols[1].astype(jnp.int32),
                     cols[2].astype(jnp.int32), cols[3].astype(jnp.int32))
        nxt = _l2_lookup(L2, c) + base + cnt
        nxt = jnp.where(k == primary, 0, nxt)
        k2 = jnp.where(active, nxt, k)
        steps2 = jnp.where(active, steps + 1, steps)
        return (k2, steps2, it + 1)

    k, steps, _ = jax.lax.while_loop(cond, body, (k, steps, jnp.int32(0)))
    srow = k // sa_intv
    srows = blocks[sad_off + (srow >> 3)]
    sample = jax.lax.bitcast_convert_type(
        _sel8(srow & 7, [srows[:, j] for j in range(8)]), jnp.int32)
    return k, steps, steps + sample
