"""Wide (64-bit) JAX/XLA FM-index engine for genomes whose fwd+RC text
reaches or exceeds 2^31 bases — the GRCh38 class the reference handles
with plain int64 state (/root/reference/src/structure.h:29-45,
bwt_search.cpp:127-182).

Design decisions:
- All 64-bit values are hand-rolled (lo, hi) uint32 pairs: flipping
  jax_enable_x64 is a process-global config change that would
  invalidate the persistent compilation cache for every 32-bit
  program; explicit pairs keep the narrow engine untouched and compile
  to the same flat uint32 elementwise ops. (The pairs were forced by an
  earlier accelerator without native int64; whether the GPU still
  needs them is open.)
- Block layout widens to 16 uint32 words per 128 BWT bases:
  [occ_A..occ_T lo | occ_A..occ_T hi | w0..w7] — the same 0.5 bytes
  per base as the narrow layout (8 words / 64 bases), still ONE
  aligned row gather per Occ query. 128 matches the reference's occ
  checkpoint interval (bwt_search.cpp:3-5).
- Same automaton/dataflow as the narrow engine (ops/fm_jax.py): each
  loop iteration issues exactly one merged 2R-row gather, everything
  else is flat (R,) uint32/int32 elementwise work — including the narrow
  engine's fast paths, widened to pair state: the K-mer LUT init
  (consume K characters in one iteration) and the single-occurrence
  fast-extension modes (LF-walk to the lone occurrence, then finish
  the maximal match by direct genome comparison 16 bases/iteration).
  Packed genome words and SA samples ride as extra 16-word rows of
  the same merged table, so every mode is served by the same gather.
- Index sharding for genomes larger than one chip's HBM: pass
  index_mesh and the block/sad tables are placed with
  PartitionSpec("index", None); XLA GSPMD partitions every row gather
  across the mesh with collectives — no hand-written psum walk.

Results are bit-identical to ops/fm_numpy.FMIndexNumpy (tested on the
toy index and on a synthetic >2^31 genome).
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np

from ..index import layout_cache
from ..index.loader import Index
from .fm_jax import _clz32, _expand16, _pc_even, _sel4, _sel8, _tr

BLOCK_W = 128  # bases per wide occ-checkpoint row


# ---------------- (lo, hi) uint32 pair arithmetic ----------------
#
# Values are unsigned 64-bit split into two uint32 vectors. Negative
# sentinels (-1) travel in two's complement and survive add/sub.


def _p_const(v: int):
    """Static int -> (lo, hi) python ints for baking into jit."""
    v &= (1 << 64) - 1
    return v & 0xFFFFFFFF, v >> 32


def _p_add(alo, ahi, blo, bhi):
    lo = alo + blo
    carry = (lo < blo).astype(jnp.uint32)
    return lo, ahi + bhi + carry


def _p_add_i32(alo, ahi, b):
    """Add a signed int32 vector (sign-extended) to a pair."""
    blo = b.astype(jnp.uint32)
    bhi = (b >> 31).astype(jnp.uint32)  # arithmetic: 0 or 0xFFFFFFFF
    return _p_add(alo, ahi, blo, bhi)


def _p_sub(alo, ahi, blo, bhi):
    borrow = (alo < blo).astype(jnp.uint32)
    return alo - blo, ahi - bhi - borrow


def _p_lt(alo, ahi, blo, bhi):
    return (ahi < bhi) | ((ahi == bhi) & (alo < blo))


def _p_le(alo, ahi, blo, bhi):
    return (ahi < bhi) | ((ahi == bhi) & (alo <= blo))


def _p_eq(alo, ahi, blo, bhi):
    return (alo == blo) & (ahi == bhi)


def _p_nonzero(alo, ahi):
    return (alo | ahi) != 0


def _p_where(c, alo, ahi, blo, bhi):
    return jnp.where(c, alo, blo), jnp.where(c, ahi, bhi)


def _p_shr(alo, ahi, s: int):
    """Logical right shift by a static 1..31."""
    return (alo >> s) | (ahi << (32 - s)), ahi >> s


def _split64(v: np.ndarray):
    """Host helper: int64/uint64 array -> (lo, hi) uint32 arrays."""
    u = np.asarray(v).astype(np.int64).view(np.uint64)
    return (u & 0xFFFFFFFF).astype(np.uint32), (u >> 32).astype(np.uint32)


def _join64(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    return (lo.astype(np.uint64)
            | (hi.astype(np.uint64) << 32)).view(np.int64)


def _sel4_pair(c, vals):
    """vals: tuple of 4 (lo, hi) pairs."""
    return (_sel4(c, vals[0][0], vals[1][0], vals[2][0], vals[3][0]),
            _sel4(c, vals[0][1], vals[1][1], vals[2][1], vals[3][1]))


# ---------------- layout ----------------


def build_device_layout_wide(idx: Index) -> np.ndarray:
    """(n_blocks, 16) uint32 rows: 4 occ lo, 4 occ hi, 8 BWT words
    covering 128 bases (top bits first within each word). Built by the
    native single-pass packer when available (NumPy's broadcasting
    path degrades badly past 2^31 elements — ~37 min at 2.2e9 text vs
    seconds in C++); the NumPy body is the toolchain-free twin."""
    n = idx.seq_len
    n_blocks = (n + BLOCK_W - 1) // BLOCK_W
    try:
        import ctypes

        from ..native import build as native_build

        lib = native_build.load()
    except Exception:
        lib = None
    if lib is not None and hasattr(lib, "dart_wide_layout"):
        out = np.empty((n_blocks, 16), dtype=np.uint32)
        bwt = np.ascontiguousarray(idx.bwt, dtype=np.uint8)
        lib.dart_wide_layout(
            bwt.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.c_int64(n),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)))
        return out
    padded = np.zeros(n_blocks * BLOCK_W, dtype=np.uint8)
    padded[:n] = idx.bwt
    onehot = padded.reshape(n_blocks, BLOCK_W, 1) == np.arange(4, dtype=np.uint8)
    per_block = onehot.sum(axis=1).astype(np.int64)
    occ_start = np.zeros((n_blocks, 4), dtype=np.int64)
    np.cumsum(per_block[:-1], axis=0, out=occ_start[1:])
    olo, ohi = _split64(occ_start)
    w = padded.reshape(-1, 16).astype(np.uint32)
    shifts = np.arange(15, -1, -1, dtype=np.uint32) * 2
    words = (w << shifts).sum(axis=1, dtype=np.uint64).astype(
        np.uint32).reshape(n_blocks, 8)
    return np.concatenate([olo, ohi, words], axis=1)


# ---------------- kernels ----------------


def _word_masks8(take):
    """Masks keeping the first `take` (1..128) bases of an 8-word group."""
    ms = []
    for j in range(8):
        tw = jnp.clip(take - j * 16, 0, 16)
        shift = jnp.minimum((16 - tw) * 2, 31)
        m = jnp.where(tw == 0, jnp.uint32(0),
                      jnp.uint32(0xFFFFFFFF) << shift.astype(jnp.uint32))
        ms.append(m)
    return ms


def _occ4_cols_wide(cols, kk_lo, kk_hi):
    """Occ(kk, c) for all c from 16 gathered row columns; kk is a
    $-row-adjusted pair. Returns 4 (lo, hi) pairs."""
    take = (kk_lo.astype(jnp.int32) & 127) + 1
    masks = _word_masks8(take)
    wms = [cols[8 + j] & masks[j] for j in range(8)]
    pad = BLOCK_W - take
    out = []
    for c in range(4):
        cnt = jnp.zeros_like(take)
        for wm in wms:
            hi = wm if (c & 2) else ~wm
            lo = wm if (c & 1) else ~wm
            cnt = cnt + _pc_even((hi >> 1) & lo & jnp.uint32(0x55555555))
        if c == 0:
            cnt = cnt - pad  # masked-off bases read as base 0
        out.append(_p_add_i32(cols[c], cols[4 + c], cnt))
    return out


def _adjust_k(q_lo, q_hi, primary: int):
    """kk = max(q - (q >= primary), 0) as pairs (bwt_occ4's $-row skip);
    also returns the block-row gather index (int32)."""
    plo, phi = _p_const(primary)
    ge = ~_p_lt(q_lo, q_hi, jnp.uint32(plo), jnp.uint32(phi))
    klo, khi = _p_add_i32(q_lo, q_hi, -(ge.astype(jnp.int32)))
    # q >= 0 and primary >= 1 keep kk >= -1; clamp -1 (0xFF.., 0xFF..) to 0
    neg = khi == jnp.uint32(0xFFFFFFFF)
    klo = jnp.where(neg, 0, klo)
    khi = jnp.where(neg, 0, khi)
    row_lo, _ = _p_shr(klo, khi, 7)
    return klo, khi, row_lo.astype(jnp.int32)


def _occ4_pair_wide(blocks, q1, q2, primary: int):
    """Occ4 at two pair positions with ONE merged row gather
    (bwt_2occ4 semantics widened). q1/q2: (lo, hi). Returns (tk, tl)
    as tuples of 4 pairs each."""
    n = q1[0].shape[0]
    k1lo, k1hi, r1 = _adjust_k(q1[0], q1[1], primary)
    k2lo, k2hi, r2 = _adjust_k(q2[0], q2[1], primary)
    rows = blocks[jnp.concatenate([r1, r2])]          # (2N, 16), one gather
    cols = [rows[:, j] for j in range(16)]
    occ = _occ4_cols_wide(cols, jnp.concatenate([k1lo, k2lo]),
                          jnp.concatenate([k1hi, k2hi]))
    tk = [(p[0][:n], p[1][:n]) for p in occ]
    tl = [(p[0][n:], p[1][n:]) for p in occ]
    return tk, tl


def _l2_pair(L2lo, L2hi, c):
    """L2[c] for per-lane c in 0..4 as a pair select tree."""
    rlo = jnp.where(c == 0, L2lo[0], L2lo[4])
    rhi = jnp.where(c == 0, L2hi[0], L2hi[4])
    for i in (1, 2, 3):
        rlo = jnp.where(c == i, L2lo[i], rlo)
        rhi = jnp.where(c == i, L2hi[i], rhi)
    return rlo, rhi


def _backward_ext_wide(L2lo, L2hi, x0, x1, x2, tk, tl, primary: int):
    """Wide BWT_Search extension step (bwt_search.cpp:150-171):
    returns per-base (starts, new_x1, widths) as pair tuples."""
    w = [_p_sub(tl[c][0], tl[c][1], tk[c][0], tk[c][1]) for c in range(4)]
    plo, phi = _p_const(primary)
    plo = jnp.uint32(plo)
    phi = jnp.uint32(phi)
    le = _p_le(x1[0], x1[1], plo, phi)                       # x1 <= primary
    end_lo, end_hi = _p_add(x1[0], x1[1], x2[0], x2[1])
    end_lo, end_hi = _p_add_i32(end_lo, end_hi, jnp.int32(-1))
    ge = ~_p_lt(end_lo, end_hi, plo, phi)                    # x1+x2-1 >= primary
    adj = (le & ge).astype(jnp.int32)
    s3 = _p_add_i32(x0[0], x0[1], adj)
    s2 = _p_add(s3[0], s3[1], w[3][0], w[3][1])
    s1 = _p_add(s2[0], s2[1], w[2][0], w[2][1])
    s0 = _p_add(s1[0], s1[1], w[1][0], w[1][1])
    starts = (s0, s1, s2, s3)
    nx1 = []
    for c in range(4):
        v = _p_add(tk[c][0], tk[c][1], L2lo[c], L2hi[c])
        nx1.append(_p_add_i32(v[0], v[1], jnp.int32(1)))
    return starts, tuple(nx1), w


def _sel16(i, cols):
    """Per-lane 16-way select by i in 0..15 from 16 column vectors."""
    lo = _sel8(i & 7, cols[:8])
    hi = _sel8(i & 7, cols[8:])
    return jnp.where(i >= 8, hi, lo)


def _lut_extend_wide(blocks, L2lo, L2hi, x0, x1, x2, *, primary):
    """One wide LUT-build level (see the narrow _lut_extend): extend
    every parent walk state by each of the 4 bases, children
    interleaved. All state as (lo, hi) pairs. Dead parents stay dead."""
    alive = _p_nonzero(*x2)
    zero = jnp.zeros_like(x0[0])
    q1 = _p_add_i32(x1[0], x1[1], jnp.int32(-1))
    q2 = _p_add(q1[0], q1[1], x2[0], x2[1])
    q1 = _p_where(alive, q1[0], q1[1], zero, zero)
    q2 = _p_where(alive, q2[0], q2[1], zero, zero)
    tk, tl = _occ4_pair_wide(blocks, q1, q2, primary)
    starts, nx1, w = _backward_ext_wide(L2lo, L2hi, x0, x1, x2, tk, tl,
                                        primary)
    n4 = 4 * x0[0].shape[0]

    def gather_children(vals):
        lo = jnp.stack([vals[3 - c][0] for c in range(4)], axis=1)
        hi = jnp.stack([vals[3 - c][1] for c in range(4)], axis=1)
        return lo, hi

    cx0 = gather_children(starts)
    cx1 = gather_children(nx1)
    cw = gather_children(w)
    ok = alive[:, None] & ((cw[0] | cw[1]) != 0)
    z = jnp.uint32(0)
    return ((jnp.where(ok, cx0[0], z).reshape(n4),
             jnp.where(ok, cx0[1], z).reshape(n4)),
            (jnp.where(ok, cx1[0], z).reshape(n4),
             jnp.where(ok, cx1[1], z).reshape(n4)),
            (jnp.where(ok, cw[0], z).reshape(n4),
             jnp.where(ok, cw[1], z).reshape(n4)))


def build_lut_wide(blocks, L2lo, L2hi, primary: int, K: int):
    """Wide K-mer walk-state LUT (see the narrow build_lut): for every
    K-mer, the bidirectional interval after its K characters, as
    (4^K, 6) uint32 rows [x0lo, x0hi, x1lo, x1hi, x2lo, x2hi]
    (x2 == 0 marks a dead walk)."""
    c = np.arange(4, dtype=np.int32)
    l2 = np.asarray(L2lo).astype(np.uint64) | (
        np.asarray(L2hi).astype(np.uint64) << 32)
    x0 = _split64((l2[c] + 1).view(np.int64))
    x1 = _split64((l2[3 - c] + 1).view(np.int64))
    x2 = _split64((l2[c + 1] - l2[c]).view(np.int64))
    ext = jax.jit(functools.partial(_lut_extend_wide, primary=primary))
    x0 = tuple(map(jnp.asarray, x0))
    x1 = tuple(map(jnp.asarray, x1))
    x2 = tuple(map(jnp.asarray, x2))
    for _ in range(K - 1):
        x0, x1, x2 = ext(blocks, L2lo, L2hi, x0, x1, x2)
    return jax.jit(lambda a, b, d: jnp.stack(
        [a[0], a[1], b[0], b[1], d[0], d[1]], axis=1))(x0, x1, x2)


def _seed_scan_kernel_wide(blocks, L2lo, L2hi, words, nmask1, rlens, *,
                           primary, max_dup, max_seeds, max_iters,
                           lut=None, lut_k=0, ref_off=0, sad_off=0,
                           sa_intv=0, seq_len=0):
    """Wide device automaton replaying the reference seeding scan
    (IdentifySeedPairs, AlignmentCandidates.cpp:188-211) with 64-bit
    interval state as uint32 pairs. One lane per read; same control
    flow and fast paths as the narrow _seed_scan_kernel:

    - K-mer LUT init (lut/lut_k): consume K characters in one
      iteration; states for every position are pre-gathered once.
    - Fast extension (ref_off/sad_off): a walk whose interval narrows
      to one occurrence LF-walks to its text position (mode LOCATE,
      pair row state) and finishes the maximal match by comparing the
      read against the genome 16 bases per iteration (mode COMPARE).
      Such seeds emit freq == -1 with the genome position pair in the
      k0 slots. Genome words (16 words = 256 bases/row) and SA samples
      (8 pairs/row: [lo x8 | hi x8]) live as extra rows of the same
      table, so every mode shares the single 2R-row gather.

    Emits (done, nseeds, rpos, len, k0_lo, k0_hi, freq)."""
    R = words.shape[0]
    Lw = words.shape[1] - 1
    L = Lw * 16
    Wn = nmask1.shape[1] - 1
    S = max_seeds
    fast = ref_off > 0 and sa_intv > 0 and (sa_intv & (sa_intv - 1)) == 0
    zero = jnp.zeros(R, jnp.uint32)
    use_lut = lut is not None and lut_k > 0
    # see the narrow kernel: LUT states pre-gathered per position;
    # DART_TPU_LUT_PRE=0 switches to in-loop gathers
    lut_pre = os.environ.get("DART_TPU_LUT_PRE", "1") != "0"
    rwords = words                    # same 2-bit top-first packing
    iota_w = jax.lax.broadcasted_iota(jnp.int32, (1, Lw + 1), 1)
    iota_n = jax.lax.broadcasted_iota(jnp.int32, (1, Wn + 1), 1)
    if use_lut and lut_pre:
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
        pre = lut[jnp.where(badp, 0, keyp).reshape(-1)].reshape(R, L, 6)
        li = [pre[..., j] for j in range(6)]
        li[4] = jnp.where(badp, jnp.uint32(0), li[4])
        li[5] = jnp.where(badp, jnp.uint32(0), li[5])
    if fast:
        # 2-bit N-mismatch mask for the genome-compare step, expanded
        # from the 1-bit transfer mask (see the narrow kernel)
        nw_cols = []
        for c in range(Lw // 2):
            m = nmask1[:, c]
            for half in (m >> jnp.uint32(16), m & jnp.uint32(0xFFFF)):
                e = _expand16(half)
                nw_cols.append(e | (e << 1))
        nw_cols.append(jnp.zeros((R,), jnp.uint32))
        nwords = jnp.stack(nw_cols, axis=1)
        sa_shift = int(sa_intv).bit_length() - 1
        sa_mask = jnp.uint32(sa_intv - 1)
        slenlo, slenhi = _p_const(seq_len)
        slenlo = jnp.uint32(slenlo)
        slenhi = jnp.uint32(slenhi)

    end_pos = jnp.maximum(rlens - 13, 0)
    pos = jnp.zeros(R, jnp.int32)
    cur = jnp.zeros(R, jnp.int32)   # cur == pos -> not initialized
    x0 = (zero, zero)
    x1 = (zero, zero)
    x2 = (zero, zero)
    nseeds = jnp.zeros(R, jnp.int32)
    mode = jnp.zeros(R, jnp.int32)   # 0 scan, 1 locate, 2 compare
    lk = (zero, zero)                # LOCATE: current row (pair)
    steps = jnp.zeros(R, jnp.int32)  # LOCATE: LF steps taken
    gb = (zero, zero)                # COMPARE: occurrence pos - pos (pair)
    done = pos >= end_pos
    out_rpos = jnp.zeros((S, R), jnp.int32)
    out_len = jnp.zeros((S, R), jnp.int32)
    out_k0lo = jnp.zeros((S, R), jnp.uint32)
    out_k0hi = jnp.zeros((S, R), jnp.uint32)
    out_freq = jnp.zeros((S, R), jnp.int32)
    slot_ids = jax.lax.broadcasted_iota(jnp.int32, (S, 1), 0)
    mdlo, mdhi = _p_const(max_dup)

    def cond(st):
        return jnp.any(~st[0][0]) & (st[1] < max_iters)

    def body(outer_st):
        st, it = outer_st
        (done, pos, cur, x0lo, x0hi, x1lo, x1hi, x2lo, x2hi, nseeds,
         mode, lklo, lkhi, steps, gblo, gbhi,
         out_rpos, out_len, out_k0lo, out_k0hi, out_freq) = st
        x0 = (x0lo, x0hi)
        x1 = (x1lo, x1hi)
        x2 = (x2lo, x2hi)

        initing = (~done) & (cur == pos)
        working = (~done) & (cur > pos)
        scanning = working & (mode == 0)
        if fast:
            # a fresh x2==1 lane starts its LF walk THIS iteration
            to_loc = (scanning & (x2[0] == 1) & (x2[1] == 0)
                      & (cur < rlens))
            scanning = scanning & ~to_loc
            locating = (working & (mode == 1)) | to_loc
            comparing = working & (mode == 2)
            lk_eff = _p_where(to_loc, x0[0], x0[1], lklo, lkhi)
            steps_eff = jnp.where(to_loc, 0, steps)
        else:
            to_loc = jnp.zeros_like(scanning)
            locating = to_loc
            comparing = to_loc
            lk_eff = (lklo, lkhi)
            steps_eff = steps

        # packed-word character read (see the narrow kernel)
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
            i_vals = [jnp.sum(jnp.where(oh_l, v, jnp.uint32(0)), axis=1,
                              dtype=jnp.uint32) for v in li]
            i_x0 = (i_vals[0], i_vals[1])
            i_x1 = (i_vals[2], i_vals[3])
            i_x2 = (i_vals[4], i_vals[5])
            init_ok = (i_vals[4] | i_vals[5]) != 0
            init_jump = lut_k
        elif use_lut:
            # per-iteration K-mer window + ONE R-row LUT gather (see
            # the narrow kernel for the derivation)
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
            i_x0 = (lrow[:, 0], lrow[:, 1])
            i_x1 = (lrow[:, 2], lrow[:, 3])
            i_x2 = (jnp.where(bad, jnp.uint32(0), lrow[:, 4]),
                    jnp.where(bad, jnp.uint32(0), lrow[:, 5]))
            init_ok = (i_x2[0] | i_x2[1]) != 0
            init_jump = lut_k
        else:
            i_x0 = _p_add_i32(*_l2_pair(L2lo, L2hi, c_safe), jnp.int32(1))
            i_x1 = _p_add_i32(*_l2_pair(L2lo, L2hi, 3 - c_safe),
                              jnp.int32(1))
            i_x2 = _p_sub(*_l2_pair(L2lo, L2hi, c_safe + 1),
                          *_l2_pair(L2lo, L2hi, c_safe))
            init_ok = ~amb
            init_jump = 1

        # ---- THE gather: one 2R-row fetch serves every mode + init ----
        q1 = _p_add_i32(x1[0], x1[1], jnp.int32(-1))
        q2 = _p_add(q1[0], q1[1], x2[0], x2[1])
        q1 = _p_where(scanning, q1[0], q1[1], *lk_eff)
        q1 = _p_where(scanning | locating, q1[0], q1[1], zero, zero)
        q2 = _p_where(scanning, q2[0], q2[1], zero, zero)
        k1lo, k1hi, rowA = _adjust_k(q1[0], q1[1], primary)
        k2lo, k2hi, rowB = _adjust_k(q2[0], q2[1], primary)
        if fast:
            loc_hit = locating & ((lk_eff[0] & sa_mask) == 0)
            goff = _p_add_i32(gblo, gbhi, cur)
            gsafe = _p_where(comparing, goff[0], goff[1], zero, zero)
            grow_lo, _ = _p_shr(gsafe[0], gsafe[1], 8)
            grow = grow_lo.astype(jnp.int32)
            srow_lo, _ = _p_shr(lk_eff[0], lk_eff[1], sa_shift)
            srow = srow_lo.astype(jnp.int32)
            rowA = jnp.where(comparing, ref_off + grow,
                             jnp.where(loc_hit, sad_off + (srow >> 3),
                                       rowA))
            rowB = jnp.where(comparing, ref_off + grow + 1, rowB)
        else:
            loc_hit = to_loc
        rows = blocks[jnp.concatenate([rowA, rowB])]   # (2R, 16), one gather
        colsA = [rows[:R, j] for j in range(16)]
        colsB = [rows[R:, j] for j in range(16)]
        occA = _occ4_cols_wide(colsA, k1lo, k1hi)  # tk (scan) / occ (locate)
        occB = _occ4_cols_wide(colsB, k2lo, k2hi)  # tl (scan)

        # ---- scan step ----
        starts, nx1, w = _backward_ext_wide(L2lo, L2hi, x0, x1, x2,
                                            occA, occB, primary)
        ci = 3 - c_safe
        wi = _sel4_pair(ci, w)
        can_extend = scanning & ~amb & _p_nonzero(*wi)
        scan_end = scanning & ~can_extend

        if fast:
            # ---- locate step (bwt_sa LF walk, row already fetched) ----
            loc_step = locating & ~loc_hit
            word = _sel8(((k1lo >> 4) & 7).astype(jnp.int32),
                         [colsA[8 + j] for j in range(8)])
            shift = ((~k1lo & 15) << 1).astype(jnp.uint32)
            cbit = ((word >> shift) & 3).astype(jnp.int32)
            occ_c = _sel4_pair(cbit, occA)
            l2c = _l2_pair(L2lo, L2hi, cbit)
            lk_next = _p_add(occ_c[0], occ_c[1], l2c[0], l2c[1])
            plo_c, phi_c = _p_const(primary)
            at_primary = _p_eq(lk_eff[0], lk_eff[1],
                               jnp.uint32(plo_c), jnp.uint32(phi_c))
            lk_next = _p_where(at_primary, zero, zero,
                               lk_next[0], lk_next[1])
            # sad value: this lane's sample pair from its (sad) row
            sidx = srow & 7
            sad_val = (_sel8(sidx, colsA[:8]), _sel8(sidx, colsA[8:]))
            g_abs = _p_add_i32(sad_val[0], sad_val[1], steps_eff)

            # ---- compare step: 16 bases per iteration ----
            jword = ((gsafe[0] >> 4) & 15).astype(jnp.int32)
            gw1 = _sel16(jword, colsA)
            gw2 = jnp.where(jword < 15, _sel16(jword + 1, colsA), colsB[0])
            aoff = ((gsafe[0] & 15) << 1).astype(jnp.uint32)
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
            # avail = min(16, rlens - cur, seq_len - goff), floored at 0
            diff = _p_sub(slenlo, slenhi, goff[0], goff[1])
            neg = diff[1] == jnp.uint32(0xFFFFFFFF)
            avail_seq = jnp.where(
                neg, 0,
                jnp.where((diff[1] != 0) | (diff[0] >= 16), 16,
                          diff[0].astype(jnp.int32)))
            avail = jnp.minimum(jnp.minimum(16, rlens - cur), avail_seq)
            matched = jnp.minimum(matched16, jnp.maximum(avail, 0))
            cur_c = cur + jnp.where(comparing, matched, 0)
            goff_c = _p_add_i32(gblo, gbhi, cur_c)
            g_end = ~_p_lt(goff_c[0], goff_c[1], slenlo, slenhi)
            cmp_end = comparing & ((matched < 16) | (cur_c >= rlens)
                                   | g_end)
        else:
            loc_step = to_loc
            lk_next = lk_eff
            g_abs = (zero, zero)
            cur_c = cur
            cmp_end = to_loc

        # ---- seed end: accept/emit/jump ----
        any_end = scan_end | cmp_end
        length = jnp.where(cmp_end, cur_c, cur) - pos
        acc_scan = (scan_end & _p_le(x2[0], x2[1], jnp.uint32(mdlo),
                                     jnp.uint32(mdhi)) & (length >= 16))
        acc_cmp = cmp_end & (length >= 16)  # unique: freq 1 <= max_dup
        acc = acc_scan | acc_cmp
        gpos = _p_add_i32(gblo, gbhi, pos)
        k0_val = _p_where(cmp_end, gpos[0], gpos[1], x0[0], x0[1])
        fr_val = jnp.where(cmp_end, -1, x2[0].astype(jnp.int32))

        def emit(args):
            o_rpos, o_len, o_k0lo, o_k0hi, o_freq = args
            hit = acc[None, :] & (slot_ids == nseeds[None, :])
            return (jnp.where(hit, pos[None, :], o_rpos),
                    jnp.where(hit, length[None, :], o_len),
                    jnp.where(hit, k0_val[0][None, :], o_k0lo),
                    jnp.where(hit, k0_val[1][None, :], o_k0hi),
                    jnp.where(hit, fr_val[None, :], o_freq))

        out_rpos, out_len, out_k0lo, out_k0hi, out_freq = jax.lax.cond(
            jnp.any(acc), emit, lambda a: a,
            (out_rpos, out_len, out_k0lo, out_k0hi, out_freq))
        nseeds = jnp.where(acc, nseeds + 1, nseeds)

        # ---- state update ----
        new_pos = jnp.where(any_end, jnp.where(acc, pos + length, pos + 1),
                            jnp.where(initing & ~init_ok, pos + 1, pos))
        new_cur = jnp.where(can_extend, cur + 1,
                            jnp.where(initing & init_ok, cur + init_jump,
                            jnp.where(comparing & ~cmp_end, cur_c,
                            jnp.where(locating, cur, new_pos))))
        sel = _sel4_pair(ci, starts)
        nx1s = _sel4_pair(ci, nx1)
        x0n = _p_where(can_extend, sel[0], sel[1],
                       *_p_where(initing & init_ok, i_x0[0], i_x0[1],
                                 x0[0], x0[1]))
        x1n = _p_where(can_extend, nx1s[0], nx1s[1],
                       *_p_where(initing & init_ok, i_x1[0], i_x1[1],
                                 x1[0], x1[1]))
        x2n = _p_where(can_extend, wi[0], wi[1],
                       *_p_where(initing & init_ok, i_x2[0], i_x2[1],
                                 x2[0], x2[1]))
        if fast:
            mode_n = jnp.where(loc_hit & locating, 2,
                               jnp.where(to_loc, 1,
                                         jnp.where(any_end, 0, mode)))
            lk_n = _p_where(locating,
                            *_p_where(loc_step, lk_next[0], lk_next[1],
                                      *lk_eff),
                            lklo, lkhi)
            steps_n = jnp.where(locating,
                                jnp.where(loc_step, steps_eff + 1,
                                          steps_eff), steps)
            gb_base = _p_add_i32(g_abs[0], g_abs[1], -pos)
            gb_n = _p_where(loc_hit & locating, gb_base[0], gb_base[1],
                            gblo, gbhi)
        else:
            mode_n = mode
            lk_n = (lklo, lkhi)
            steps_n = steps
            gb_n = (gblo, gbhi)
        done = done | (new_pos >= end_pos)
        return ((done, new_pos, new_cur, x0n[0], x0n[1], x1n[0], x1n[1],
                 x2n[0], x2n[1], nseeds,
                 mode_n, lk_n[0], lk_n[1], steps_n, gb_n[0], gb_n[1],
                 out_rpos, out_len, out_k0lo, out_k0hi, out_freq),
                it + 1)

    st = (done, pos, cur, x0[0], x0[1], x1[0], x1[1], x2[0], x2[1], nseeds,
          mode, lk[0], lk[1], steps, gb[0], gb[1],
          out_rpos, out_len, out_k0lo, out_k0hi, out_freq)
    st, _ = jax.lax.while_loop(cond, body, (st, jnp.int32(0)))
    (done, _, _, _, _, _, _, _, _, nseeds, _, _, _, _, _, _,
     out_rpos, out_len, out_k0lo, out_k0hi, out_freq) = st
    return done, nseeds, out_rpos, out_len, out_k0lo, out_k0hi, out_freq


def _seed_scan_packed_wide(blocks, L2lo, L2hi, lut, buf, *,
                           primary, max_dup, max_seeds, max_iters,
                           read_len, lut_k=0, ref_off=0, sad_off=0,
                           sa_intv=0, seq_len=0, use_nmask=True):
    """Transfer-minimal wrapper (see narrow _seed_scan_packed): one
    merged uint32 input buffer [packed codes | nmask iff use_nmask |
    rlen]; one packed int32 result buffer [done|nseeds<<1,
    (rpos<<16|len) x S, k0_lo x S, k0_hi x S, freq x S] (freq == -1
    marks a direct seed whose k0 pair holds the genome position)."""
    S = max_seeds
    R = buf.shape[0]
    words = read_len // 16
    rlens = jax.lax.bitcast_convert_type(buf[:, -1], jnp.int32)
    pad = jnp.zeros((R, 1), jnp.uint32)
    # packed-word reads throughout (see the narrow wrapper): no (R, L)
    # unpacked codes matrix exists anywhere
    wcols = jnp.concatenate([buf[:, :words], pad], axis=1)
    if use_nmask:
        nmask1 = jnp.concatenate(
            [buf[:, words:words + words // 2], pad], axis=1)
    else:
        nmask1 = jnp.zeros((R, words // 2 + 1), jnp.uint32)
    done, nseeds, o_rpos, o_len, o_k0lo, o_k0hi, o_freq = (
        _seed_scan_kernel_wide(blocks, L2lo, L2hi, wcols, nmask1, rlens,
                               primary=primary, max_dup=max_dup,
                               max_seeds=S, max_iters=max_iters,
                               lut=lut, lut_k=lut_k, ref_off=ref_off,
                               sad_off=sad_off, sa_intv=sa_intv,
                               seq_len=seq_len))
    # overflowed lanes (more accepted seeds than this round's slots)
    # hold truncated results: report not-done -> full-width rerun
    done = done & (nseeds <= S)
    head = (done.astype(jnp.int32) | (nseeds << 1))[:, None]
    meta = ((o_rpos << 16) | o_len).T
    return jnp.concatenate(
        [head, meta,
         jax.lax.bitcast_convert_type(o_k0lo.T, jnp.int32),
         jax.lax.bitcast_convert_type(o_k0hi.T, jnp.int32),
         o_freq.T], axis=1)


_UNFINISHED_HI = 0x80000000


def _locate_kernel_wide(blocks, L2lo, L2hi, k_lo, k_hi, *,
                        primary, sa_intv, sad_off, max_iters):
    """Wide batched bwt_sa (bwt_search.cpp:127-137): LF-walk each row
    pair until it hits a sampled row, then add the sample. One merged
    row gather per iteration serves both the BWT character read and
    the Occ count; the final sample pair is read from the table's own
    sad region (8 pairs per 16-word row at sad_off, [lo x8 | hi x8]),
    so no separate sample arrays ride in HBM (~12 GB saved at GRCh38
    scale). Lanes exhausting max_iters return hi=_UNFINISHED_HI
    (impossible for real positions) for host-side rerun."""
    mask = jnp.uint32(sa_intv - 1)
    plo, phi = _p_const(primary)
    plo = jnp.uint32(plo)
    phi = jnp.uint32(phi)
    sa_shift = int(sa_intv).bit_length() - 1

    def cond(carry):
        klo, khi, steps, it = carry
        return jnp.any((klo & mask) != 0) & (it < max_iters)

    def body(carry):
        klo, khi, steps, it = carry
        active = (klo & mask) != 0
        kklo, kkhi, row = _adjust_k(klo, khi, primary)
        # x = k - (k > primary): differs from kk only at k == primary,
        # whose result is overridden below
        rows = blocks[row]
        cols = [rows[:, j] for j in range(16)]
        xlo = kklo  # see narrow kernel: x>>7 == kk>>7 except k==primary
        word = _sel8(((xlo >> 4) & 7).astype(jnp.int32),
                     [cols[8 + j] for j in range(8)])
        shift = ((~xlo & 15) << 1).astype(jnp.uint32)
        c = ((word >> shift) & 3).astype(jnp.int32)
        take = (kklo.astype(jnp.int32) & 127) + 1
        masks = _word_masks8(take)
        cnt = jnp.zeros_like(take)
        for j in range(8):
            wm = cols[8 + j] & masks[j]
            hi = jnp.where((c & 2) != 0, wm, ~wm)
            lo = jnp.where((c & 1) != 0, wm, ~wm)
            cnt = cnt + _pc_even((hi >> 1) & lo & jnp.uint32(0x55555555))
        cnt = jnp.where(c == 0, cnt - (BLOCK_W - take), cnt)
        base = _sel4_pair(c, [(cols[j], cols[4 + j]) for j in range(4)])
        l2 = _l2_pair(L2lo, L2hi, c)
        nxt = _p_add(base[0], base[1], l2[0], l2[1])
        nxt = _p_add_i32(nxt[0], nxt[1], cnt)
        at_primary = _p_eq(klo, khi, plo, phi)
        nxt = _p_where(at_primary, jnp.zeros_like(klo), jnp.zeros_like(khi),
                       nxt[0], nxt[1])
        klo2, khi2 = _p_where(active, nxt[0], nxt[1], klo, khi)
        steps2 = jnp.where(active, steps + 1, steps)
        return (klo2, khi2, steps2, it + 1)

    steps = jnp.zeros_like(k_lo, dtype=jnp.int32)
    klo, khi, steps, _ = jax.lax.while_loop(
        cond, body, (k_lo, k_hi, steps, jnp.int32(0)))
    finished = (klo & mask) == 0
    srow_lo, _ = _p_shr(klo, khi, sa_shift)
    srow = srow_lo.astype(jnp.int32)
    srows = blocks[sad_off + (srow >> 3)]
    sidx = srow & 7
    loc = _p_add_i32(_sel8(sidx, [srows[:, j] for j in range(8)]),
                     _sel8(sidx, [srows[:, 8 + j] for j in range(8)]),
                     steps)
    out_lo = jnp.where(finished, loc[0], 0)
    out_hi = jnp.where(finished, loc[1], jnp.uint32(_UNFINISHED_HI))
    return jnp.stack([jax.lax.bitcast_convert_type(out_lo, jnp.int32),
                      jax.lax.bitcast_convert_type(out_hi, jnp.int32)],
                     axis=1)


def _pack_ref_rows(idx: Index, n_rrows: int) -> np.ndarray:
    """Pack the fwd+RC genome codes into (n_rrows, 16) uint32 rows of
    16-base words (256 bases per row, top bits first) for the compare
    mode; native single pass when available (NumPy degrades past 2^31
    elements)."""
    n = int(idx.seq_len)
    n_words = (n + 15) // 16
    flat = np.zeros(n_rrows * 16, dtype=np.uint32)
    lib = None
    try:
        import ctypes

        from ..native import build as native_build

        lib = native_build.load()
    except Exception:
        pass
    if lib is not None and hasattr(lib, "dart_pack_codes"):
        codes = np.ascontiguousarray(idx.ref_codes, dtype=np.uint8)
        lib.dart_pack_codes(
            codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.c_int64(n),
            flat.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)))
    else:
        codes16 = np.zeros(n_words * 16, dtype=np.uint32)
        codes16[:n] = np.minimum(idx.ref_codes, 3)
        w = codes16.reshape(-1, 16)
        shifts = np.arange(15, -1, -1, dtype=np.uint64) * 2
        flat[:n_words] = (w.astype(np.uint64) << shifts).sum(
            axis=1, dtype=np.uint64).astype(np.uint32)
    return flat.reshape(n_rrows, 16)


def build_merged_table_wide(idx: Index, n_shards: int = 1):
    """Full wide merged gather table: block rows (occ lo/hi + 8 BWT
    words per 128 bases), packed genome rows (16 words = 256 bases per
    row), and SA sample pair rows (8 per row: [lo x8 | hi x8]).
    Returns (merged, ref_off, sad_off). jax-free so the layout cache
    can be warmed offline (tools/warm_layout_cache.py)."""
    seq_len = int(idx.seq_len)
    blocks = build_device_layout_wide(idx)

    def pad_rows(a):
        # pad to a shard-divisible row count (pad rows are never
        # gathered: row indexes derive from k < seq_len)
        r = (-a.shape[0]) % n_shards
        if r == 0:
            return a
        return np.concatenate([a, np.zeros((r,) + a.shape[1:], a.dtype)])

    if n_shards > 1:
        blocks = pad_rows(blocks)
    samples = (idx.sad_samples if idx.sad_intv
               else idx.sa_samples).astype(np.int64)
    slo, shi = _split64(samples)
    n_blocks = blocks.shape[0]
    n_words = (seq_len + 15) // 16
    n_rrows = -(-n_words // 16) + 1  # +1: compare may read row+1
    ref_rows = _pack_ref_rows(idx, n_rrows)
    n_srows = -(-slo.shape[0] // 8)
    sad_rows = np.zeros((n_srows, 16), dtype=np.uint32)
    srl = np.zeros(n_srows * 8, dtype=np.uint32)
    srh = np.zeros(n_srows * 8, dtype=np.uint32)
    srl[: slo.shape[0]] = slo
    srh[: shi.shape[0]] = shi
    sad_rows[:, :8] = srl.reshape(n_srows, 8)
    sad_rows[:, 8:] = srh.reshape(n_srows, 8)
    merged = np.concatenate([blocks, ref_rows, sad_rows])
    if n_shards > 1:
        merged = pad_rows(merged)
    return merged, n_blocks, n_blocks + n_rrows


# ---------------- engine ----------------


class FMIndexJaxWide:
    """64-bit device engine; engine API-compatible with FMIndexJax
    (seed_submit_packed/seed_finish/seed_reads/locate) so the whole aligner
    pipeline runs unchanged on GRCh38-scale genomes. Pass index_mesh
    (a Mesh with an "index" and/or "data" axis) to range-shard the
    block/SA tables over multiple chips when the index exceeds one
    chip's HBM and/or run the automaton data-parallel over read lanes
    (same GSPMD formulation as the narrow FMIndexJax: per-lane state is
    batch-sharded, the only cross-lane ops are gathers from the —
    possibly index-sharded — table)."""

    def __init__(self, idx: Index, device=None, max_dup_num: int = 100,
                 index_mesh=None, lut_k: int = 0):
        tab_sharding = device
        vec_sharding = device
        self._seed_sh = {}
        self._loc_sh = {}
        self._min_bucket = 1024
        n_shards = 1
        if index_mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            axes = dict(index_mesh.shape)
            n_shards = int(axes.get("index", 1))
            data_n = int(axes.get("data", 1))
            rep = NamedSharding(index_mesh, P())
            tab_sharding = (NamedSharding(index_mesh, P("index", None))
                            if n_shards > 1 else rep)
            vec_sharding = rep
            if data_n > 1:
                d1 = NamedSharding(index_mesh, P("data"))
                d2 = NamedSharding(index_mesh, P("data", None))
                self._seed_sh = dict(
                    in_shardings=(tab_sharding, rep, rep, rep, d2),
                    out_shardings=d2)
                self._loc_sh = dict(
                    in_shardings=(tab_sharding, rep, rep, d1, d1),
                    out_shardings=d2)
                self._min_bucket = max(1024, 128 * index_mesh.devices.size)
        l2lo, l2hi = _split64(idx.L2)
        self.L2lo = jax.device_put(l2lo, vec_sharding)
        self.L2hi = jax.device_put(l2hi, vec_sharding)
        # dense samples (builder .sad, sad_intv > 0): shorter LF-walks.
        # The samples ride ONLY as sad rows of the merged table below
        # (locate reads them through the same gather path); separate
        # device copies would double SA-sample HBM — ~12 GB at GRCh38
        # scale, more than the whole rest of the index
        self.sa_intv = int(idx.sad_intv) if idx.sad_intv else int(idx.sa_intv)
        self.primary = int(idx.primary)
        self.seq_len = int(idx.seq_len)
        self.max_dup_num = int(max_dup_num)
        self.lut_k = int(lut_k)
        self._lut = None  # built lazily on first seed round
        # fast-extension regions appended to the block table (matching
        # the narrow engine's merged-table design): packed genome words
        # (16 words = 256 bases per row) and SA sample pairs (8 per
        # row: [lo x8 | hi x8]) so every automaton mode is served by
        # ONE row gather from ONE table. Big unsharded indexes memmap
        # the merged table from the disk-backed layout cache —
        # file-backed faults dodge this host's anon-fault collapse
        merged = None
        cache_meta = {"seq_len": self.seq_len, "sa_intv": self.sa_intv}
        # sharded variants differ from the unsharded table only by
        # zero-row padding (shard-divisible blocks region + total), so
        # they get their own cache kind ("wtab<N>") and, on a miss, are
        # repacked from the unsharded "wtab" memmap instead of
        # re-deriving the whole layout from the raw index
        kind = "wtab" if n_shards == 1 else f"wtab{n_shards}"
        use_cache = (getattr(idx, "prefix", None)
                     and layout_cache.eligible(self.seq_len))
        if use_cache:
            merged, h = layout_cache.load_array(idx.prefix, kind,
                                                cache_meta)
            if merged is not None:
                self.ref_off, self.sad_off = int(h["ref_off"]), int(h["sad_off"])
            elif n_shards > 1:
                merged = self._repack_sharded_from_cache(idx, n_shards,
                                                         cache_meta)
        if merged is None:
            merged, self.ref_off, self.sad_off = build_merged_table_wide(
                idx, n_shards)
            if use_cache:
                layout_cache.save_array(
                    idx.prefix, kind, merged,
                    dict(cache_meta, ref_off=self.ref_off,
                         sad_off=self.sad_off))
        self.blocks = jax.device_put(merged, tab_sharding)
        self._seed_jit = {}
        self._locate_jit = {}

    def _repack_sharded_from_cache(self, idx: Index, n_shards: int,
                                   cache_meta: dict):
        """Build the n_shards-padded merged table from the cached
        unsharded one (file-backed reads, one output array) and cache
        it; returns None when the unsharded cache is absent too."""
        base, h = layout_cache.load_array(idx.prefix, "wtab", cache_meta)
        if base is None:
            return None
        ref_off, sad_off = int(h["ref_off"]), int(h["sad_off"])
        pad1 = (-ref_off) % n_shards
        n_rows = base.shape[0] + pad1
        pad2 = (-n_rows) % n_shards
        out = np.zeros((n_rows + pad2, base.shape[1]), base.dtype)
        out[:ref_off] = base[:ref_off]
        out[ref_off + pad1: base.shape[0] + pad1] = base[ref_off:]
        self.ref_off = ref_off + pad1
        self.sad_off = sad_off + pad1
        layout_cache.save_array(
            idx.prefix, f"wtab{n_shards}", out,
            dict(cache_meta, ref_off=self.ref_off, sad_off=self.sad_off))
        return out

    # -- seeding (same submit/finish protocol as the narrow engine) --

    @staticmethod
    def _pad_up(n: int, floor: int = 1024) -> int:
        # closed bucket set {2^k} U {3*2^k}; see the narrow engine
        p = floor
        while p < n:
            if (mid := p + (p >> 1)) >= n:
                return mid
            p <<= 1
        return p

    @staticmethod
    def seed_slots(Lp: int, max_rlen: int) -> int:
        s = max(1, (max_rlen - 14) // 16 + 1)
        return min(Lp // 16, s + (s & 1))

    @staticmethod
    def seed_slots_r1(s_full: int) -> int:
        """Slim round-1 slot count (see the narrow engine's
        seed_slots_r1; overflowing lanes reroute to the full-width
        rerun). The wide result rows are 1 + 4*S words, so the
        saving is proportionally larger here."""
        return min(s_full, max(4, (s_full // 2 + 1) & ~1))

    def submit_seed_round(self, buf, Rp, Lp, T, S=None, use_nmask=False):
        """One merged-buffer dispatch (see the narrow engine)."""
        if S is None:
            S = Lp // 16
        if self.lut_k and self._lut is None:
            # separate table (same rationale as the narrow engine: the
            # 4^K rows would push every merged-table gather to
            # large-table rates); states are pre-gathered once per call
            self._lut = build_lut_wide(self.blocks, self.L2lo, self.L2hi,
                                       self.primary, self.lut_k)
        key = (Rp, Lp, T, use_nmask, S)
        if key not in self._seed_jit:
            self._seed_jit[key] = jax.jit(functools.partial(
                _seed_scan_packed_wide, primary=self.primary,
                max_dup=self.max_dup_num, max_seeds=S, max_iters=T,
                read_len=Lp, lut_k=self.lut_k, ref_off=self.ref_off,
                sad_off=self.sad_off, sa_intv=self.sa_intv,
                seq_len=self.seq_len, use_nmask=use_nmask),
                **self._seed_sh)
        _tr(f"wseed submit Rp={Rp} T={T} ({buf.nbytes >> 10} KiB up)")
        return self._seed_jit[key](self.blocks, self.L2lo, self.L2hi,
                                   self._lut, jnp.asarray(buf))

    def seed_submit_packed(self, buf, nmask, has_n, n_with_n: int,
                           nlive: int, Lp: int, max_rlen: int):
        """Same protocol and N-reroute policy as the narrow engine's
        seed_submit_packed."""
        Rp = buf.shape[0]
        S = self.seed_slots(Lp, max_rlen)
        S1 = self.seed_slots_r1(S)
        words = Lp // 16
        masked = n_with_n > max(1024, nlive // 16)
        if masked:
            buf = np.concatenate(
                [buf[:, :words], nmask, buf[:, words:]], axis=1)
        # round-1 iteration cap: with dense .sad samples most lanes
        # finish in ~40-70 iterations, and excess cap is paid by the
        # WHOLE batch while only stragglers profit. Coarse sampling
        # (sa_intv > 16) adds ~sa_intv/2 LF iterations per direct seed
        # and wants more headroom. Not yet tuned on the GPU;
        # DART_TPU_T1 overrides for tuning.
        T1 = int(os.environ.get("DART_TPU_T1", "160" if self.sa_intv > 16
                                else "96"))
        dev = self.submit_seed_round(buf, Rp, Lp, T1, S1,
                                     use_nmask=masked)
        return {"dev": dev, "buf": buf, "nmask": None if masked else nmask,
                "has_n": None if masked or not n_with_n else has_n,
                "masked": masked, "nlive": nlive, "Lp": Lp, "S": S,
                "S1": S1}

    def seed_finish(self, job, on_wait=None):
        buf, nmask, has_n = job["buf"], job["nmask"], job["has_n"]
        R, Lp, S = job["nlive"], job["Lp"], job["S"]
        words = Lp // 16
        n_out = np.zeros(R, dtype=np.int32)
        rpos_out = np.zeros((R, S), dtype=np.int32)
        len_out = np.zeros((R, S), dtype=np.int32)
        k0_out = np.zeros((R, S), dtype=np.int64)
        freq_out = np.zeros((R, S), dtype=np.int32)
        lane_ids = np.arange(R, dtype=np.int64)
        first_Rp = buf.shape[0]
        # closed-form worst-case cap: a scan that restarts at every
        # position and extends to the read end costs (L+1)(L+2)/2 steps
        T_rerun = max(2048, (Lp + 1) * (Lp + 2) // 2)
        dev = job["dev"]
        rounds = 0
        while lane_ids.size:
            rounds += 1
            if rounds > 4:
                raise RuntimeError("seed scan failed to converge")
            nlive = lane_ids.size
            # round 1 ships the slim S1-slot result; reruns are full
            Sr = job["S1"] if rounds == 1 else S
            _tr(f"wseed drain r{rounds} block (nlive={nlive})")
            host = np.asarray(dev)[:nlive]
            _tr(f"wseed drain r{rounds} done")
            done = (host[:, 0] & 1) != 0
            if rounds == 1 and has_n is not None:
                # reroute N-containing reads to the masked rerun (their
                # round-1 results used substituted codes)
                done &= has_n[lane_ids] == 0
            fin = np.nonzero(done)[0]
            ids = lane_ids[fin]
            n_out[ids] = host[fin, 0] >> 1
            meta = host[fin, 1:1 + Sr]
            rpos_out[ids, :Sr] = (meta >> 16) & 0xFFFF
            len_out[ids, :Sr] = meta & 0xFFFF
            k0_out[ids, :Sr] = _join64(
                host[fin, 1 + Sr:1 + 2 * Sr].view(np.uint32),
                host[fin, 1 + 2 * Sr:1 + 3 * Sr].view(np.uint32))
            freq_out[ids, :Sr] = host[fin, 1 + 3 * Sr:1 + 4 * Sr]
            live = np.nonzero(~done)[0]
            if live.size == 0:
                break
            lane_ids = lane_ids[live]
            Rp = min(self._pad_up(lane_ids.size, self._min_bucket),
                     first_Rp)
            rb = np.zeros((Rp, words + words // 2 + 1), dtype=np.uint32)
            if job["masked"]:
                rb[:lane_ids.size] = buf[lane_ids]
            else:
                rb[:lane_ids.size, :words] = buf[lane_ids, :words]
                rb[:lane_ids.size, words:words + words // 2] = \
                    nmask[lane_ids]
                rb[:lane_ids.size, -1] = buf[lane_ids, words]
            dev = self.submit_seed_round(rb, Rp, Lp, T_rerun, S,
                                         use_nmask=True)
            if on_wait is not None:
                on_wait()
                on_wait = None
        if on_wait is not None:
            on_wait()
        return n_out, rpos_out, len_out, k0_out, freq_out

    def seed_reads(self, codes: np.ndarray, rlens: np.ndarray):
        """Batched reference seeding scan; same contract as the narrow
        FMIndexJax.seed_reads (freq == -1 marks a direct fast-extension
        seed whose k0 slot holds the genome position)."""
        R, L = codes.shape
        if L >= 65536:
            raise ValueError("reads must be shorter than 65536 bases")
        Lp = max(32, -(-L // 32) * 32)
        words = Lp // 16
        Rp = self._pad_up(R, self._min_bucket)
        rl = np.zeros(Rp, dtype=np.int32)
        rl[:R] = np.asarray(rlens, dtype=np.int32)
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

    # -- locate --

    def _locate_round(self, cur_k: np.ndarray, T: int):
        npad = self._pad_up(cur_k.size, self._min_bucket)
        klo = np.zeros(npad, dtype=np.uint32)
        khi = np.zeros(npad, dtype=np.uint32)
        lo, hi = _split64(cur_k)
        klo[: cur_k.size] = lo
        khi[: cur_k.size] = hi
        key = (npad, T)
        if key not in self._locate_jit:
            self._locate_jit[key] = jax.jit(functools.partial(
                _locate_kernel_wide, primary=self.primary,
                sa_intv=self.sa_intv, sad_off=self.sad_off,
                max_iters=T), **self._loc_sh)
        _tr(f"wlocate submit n={cur_k.size} pad={npad} T={T}")
        return self._locate_jit[key](
            self.blocks, self.L2lo, self.L2hi,
            jnp.asarray(klo), jnp.asarray(khi))

    def locate_submit(self, rows: np.ndarray):
        """Dispatch the first locate round without syncing (same
        protocol as the narrow engine)."""
        n = rows.shape[0]
        if n == 0:
            return None
        cur_k = np.asarray(rows, dtype=np.int64)
        T = int(self.sa_intv * (np.log(self._pad_up(n, self._min_bucket))
                                + 4.0) / 32 + 1) * 32
        return {"dev": self._locate_round(cur_k, T), "k": cur_k, "n": n}

    def locate_finish(self, job) -> np.ndarray:
        """Drain with straggler compaction (see the narrow engine's
        docstring); int64 out."""
        if job is None:
            return np.empty(0, dtype=np.int64)
        n = job["n"]
        out = np.zeros(n, dtype=np.int64)
        lane_ids = np.arange(n, dtype=np.int64)
        cur_k = job["k"]
        dev = job["dev"]
        while lane_ids.size:
            _tr(f"wlocate drain block (n={lane_ids.size})")
            res = np.asarray(dev)[: lane_ids.size]
            _tr("wlocate drain done")
            lo32 = res[:, 0].view(np.uint32)
            hi32 = res[:, 1].view(np.uint32)
            fin = hi32 != _UNFINISHED_HI
            out[lane_ids[fin]] = _join64(lo32[fin], hi32[fin])
            live = ~fin
            if not live.any():
                break
            lane_ids = lane_ids[live]
            cur_k = cur_k[live]
            dev = self._locate_round(cur_k, 512 * self.sa_intv)
        return out

    def locate(self, rows: np.ndarray) -> np.ndarray:
        """Batched SA lookups (submit + drain); int64 in/out."""
        return self.locate_finish(self.locate_submit(rows))
