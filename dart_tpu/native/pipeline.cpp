// Native host pipeline: seed chaining -> candidate finalization ->
// pairing -> SAM/junction output, operating on whole read chunks.
//
// This is the host-side half of the aligner: the FM-index seeding and
// SA locates run on the device (dart_tpu/ops/fm_jax.py); this library
// consumes the resulting per-read seed tables and produces SAM text
// and the splice-junction map. It reimplements, stage for stage, the
// semantics of the reference aligner's candidate pipeline
// (/root/reference/src/AlignmentCandidates.cpp, Mapping.cpp,
// tools.cpp, KmerAnalysis.cpp) as audited in the Python reference
// implementation (dart_tpu/pipeline/*.py) that is kept as the parity
// oracle. All provenance comments cite reference file:line.
//
// Interface: plain C ABI driven through ctypes (native/build.py).

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <string>
#include <thread>
#include <utility>
#include <vector>

extern "C" int64_t dart_nw(const char* s1, int64_t m, const char* s2,
                           int64_t n, char* out1, char* out2);

namespace dartp {

// ---------------------------------------------------------------- tables

static uint8_t NT4[256];
static uint8_t COMP[256];
static bool tables_ready = false;
static void init_tables() {
  if (tables_ready) return;
  for (int i = 0; i < 256; ++i) { NT4[i] = 4; COMP[i] = 'N'; }
  const char* b = "ACGT";
  for (int i = 0; i < 4; ++i) {
    NT4[(uint8_t)b[i]] = (uint8_t)i;
    NT4[(uint8_t)(b[i] + 32)] = (uint8_t)i;
  }
  NT4[(uint8_t)'-'] = 5;
  const char* p = "ACGTacgt";
  const char* q = "TGCATGCA";
  for (int i = 0; i < 8; ++i) COMP[(uint8_t)p[i]] = (uint8_t)q[i];
  tables_ready = true;
}

// splice motifs (main.cpp:18) and boundary shift order
// (AlignmentCandidates.cpp:6)
static const char* SJ_MOTIF[4] = {"GT/AG", "CT/AC", "GC/AG", "CT/GC"};
static const int SHIFT_ARR[19] = {0, 1, -1, 2, -2, 3, -3, 4, -4, 5,
                                  -5, 6, -6, 7, -7, 8, -8, 9, -9};
static const char* XS_A_STR[3] = {"", " XS:A:+", " XS:A:-"};
static const int MAX_MAPQ = 50;

// ---------------------------------------------------------------- types

struct Seed {
  int64_t gPos = 0;
  int32_t rPos = 0, rLen = 0, gLen = 0;
  int64_t PosDiff = 0;
  bool simple = false, acceptor = false;
};

struct Cand {
  int32_t Score = 0;
  int32_t SJtype = -1;
  int64_t PosDiff = 0;
  int32_t mate = -1;  // PairedAlnCanIdx
  std::vector<Seed> seeds;
};

struct Coor {
  bool dir = true;
  std::string cigar;
  int64_t gPos = 0;
  int32_t chr = 0;
};

struct Rep {
  int32_t score = 0;   // AlnScore
  int32_t sjtype = -1;
  int32_t flag = 0;    // iFrag
  int32_t mate = -1;   // PairedAlnCanIdx
  Coor coor;
};

struct Read {
  const char* seq = nullptr;
  int32_t rlen = 0;
  const char* qual = nullptr;
  int32_t qlen = 0;
  const char* hdr = nullptr;
  int32_t hlen = 0;
  int32_t score = 0, sub = 0, mis = 0, mapq = 0, best = 0, can_num = 0;
  std::vector<Rep> reps;
  std::vector<Cand> cans;
};

struct Ctx {
  const uint8_t* ref = nullptr;  // expanded ASCII genome, fwd ++ RC
  int64_t seq_len = 0, genome = 0;
  std::vector<int64_t> keys;   // ChrLocMap end keys (sorted)
  std::vector<int32_t> kidx;   // -> chromosome index
  std::vector<std::string> chr_names;
  std::vector<int64_t> chr_fwd;
  int32_t max_gaps = 5, max_intron = 500000, min_intron = 5, max_mismatch = 0;
  bool multi = false, unique = false, all_sj = false;
  std::map<std::pair<int64_t, int64_t>, std::pair<int, int>> sj;
  std::string sam;
  std::vector<int64_t> sj_buf;
  int64_t n_unique = 0, n_unmapped = 0, n_paired = 0;
};

typedef std::vector<std::pair<int, char>> Cigar;

// reusable scratch to avoid per-call allocation
struct Scratch {
  std::vector<char> a1, a2;
};
static thread_local Scratch g_scr;

static void nw(const char* s1, int64_t m, const char* s2, int64_t n,
               std::vector<char>& o1, std::vector<char>& o2, int64_t& k) {
  o1.resize((size_t)(m + n + 1));
  o2.resize((size_t)(m + n + 1));
  k = dart_nw(s1, m, s2, n, o1.data(), o2.data());
}

// chr_lower_bound: first key >= g (std::map::lower_bound on end keys,
// bwt_index.cpp:241-251 construction)
static inline size_t chr_lb(const Ctx& C, int64_t g) {
  return (size_t)(std::lower_bound(C.keys.begin(), C.keys.end(), g) -
                  C.keys.begin());
}

// ------------------------------------------------- chaining (cpp:241-288)

static void gen_candidates(const Ctx& C, int32_t rlen,
                           std::vector<Seed>& seeds, std::vector<Cand>& out) {
  size_t num = seeds.size();
  out.clear();
  if (num == 0) return;
  int thr = (int)(rlen * 0.3);
  size_t i = 0;
  while (i < num && seeds[i].PosDiff < 0) ++i;
  while (i < num) {
    Cand can;
    can.Score = seeds[i].rLen;
    can.seeds.assign(1, seeds[i]);
    size_t j = i, k = i + 1;
    while (k < num) {
      int64_t pd = seeds[k].PosDiff - seeds[j].PosDiff;
      if (pd < 0) pd = -pd;
      bool chainable = pd < C.max_gaps;
      if (!chainable && pd < C.max_intron &&
          seeds[k].rPos > seeds[j].rPos) {
        size_t kk = chr_lb(C, seeds[j].gPos);
        chainable = kk < C.keys.size() && seeds[k].gPos < C.keys[kk];
      }
      if (chainable) {
        can.Score += seeds[k].rLen;
        can.seeds.push_back(seeds[k]);
        j = k;
        ++k;
      } else {
        break;
      }
    }
    if (can.Score > thr) {
      can.PosDiff = can.seeds[0].PosDiff;
      if (can.PosDiff < 0) can.PosDiff = 0;
      out.push_back(std::move(can));
    }
    i = k;
  }
}

// ------------------------------------------ candidate pruning (Mapping.cpp)

// Mapping.cpp:371-401
static void remove_redundant(std::vector<Cand>& av) {
  if (av.size() <= 1) return;
  int s1 = 0, s2 = 0;
  for (auto& c : av) {
    if (c.Score > s2) {
      if (c.Score >= s1) { s2 = s1; s1 = c.Score; }
      else s2 = c.Score;
    } else if (c.Score == s2) {
      s2 = s1;
    }
  }
  int thr = (s1 == s2 || s1 - s2 > 20) ? s1 : s2;
  for (auto& c : av)
    if (c.Score < thr) c.Score = 0;
}

// Mapping.cpp:403-450
static bool check_paired_cans(std::vector<Cand>& av1, std::vector<Cand>& av2) {
  bool pairing = false;
  size_t n1 = av1.size(), n2 = av2.size();
  if (n1 * n2 > 1000) { remove_redundant(av1); remove_redundant(av2); }
  for (size_t i = 0; i < n1; ++i) {
    if (av1[i].Score == 0) continue;
    int best = -1;
    int64_t min_dist = 2000000;
    for (size_t j = 0; j < n2; ++j) {
      if (av2[j].Score == 0 || av2[j].PosDiff < av1[i].PosDiff) continue;
      int64_t d = av2[j].PosDiff - av1[i].PosDiff;
      if (d < 0) d = -d;
      if (d < min_dist) { best = (int)j; min_dist = d; }
    }
    if (best != -1) {
      size_t j = (size_t)best;
      if (av2[j].mate == -1) {
        pairing = true;
        av1[i].mate = (int)j;
        av2[j].mate = (int)i;
      } else if (av1[i].Score > av1[(size_t)av2[j].mate].Score) {
        av1[(size_t)av2[j].mate].mate = -1;
        av1[i].mate = (int)j;
        av2[j].mate = (int)i;
      }
    }
  }
  return pairing;
}

// Mapping.cpp:452-477
static void remove_unmated(std::vector<Cand>& av1, std::vector<Cand>& av2) {
  for (auto& c : av1) {
    if (c.mate == -1) c.Score = 0;
    else {
      Cand& m = av2[(size_t)c.mate];
      c.Score = m.Score = c.Score + m.Score;
    }
  }
  for (auto& c : av2)
    if (c.mate == -1) c.Score = 0;
}

// ----------------------------------------------- k-mer reseed (KmerAnalysis)

static const int KMER = 8;
static const uint32_t KMER_POW = 0x3FFF;

// KmerAnalysis.cpp:34-80
static void kmer_vec(const char* s, int64_t n,
                     std::vector<std::pair<uint32_t, int64_t>>& vec) {
  vec.clear();
  int64_t tail = 0;
  int count = 0;
  while (count < KMER && tail < n) {
    if (s[tail] != 'N') ++count; else count = 0;
    ++tail;
  }
  if (count != KMER) return;
  int64_t head = tail - KMER;
  uint32_t wid = 0;
  for (int64_t i = head; i < head + KMER; ++i)
    wid = (wid << 2) + NT4[(uint8_t)s[i]];
  vec.emplace_back(wid, head);
  ++head;
  while (tail < n) {
    if (s[tail] != 'N') {
      wid = ((wid & KMER_POW) << 2) + NT4[(uint8_t)s[tail]];
      vec.emplace_back(wid, head);
      ++head;
      ++tail;
    } else {
      count = 0;
      ++tail;
      while (count < KMER && tail < n) {
        if (s[tail] != 'N') ++count; else count = 0;
        ++tail;
      }
      if (count == KMER) {
        head = tail - KMER;
        wid = 0;
        for (int64_t i = head; i < head + KMER; ++i)
          wid = (wid << 2) + NT4[(uint8_t)s[i]];
        vec.emplace_back(wid, head);
        ++head;
      } else {
        break;
      }
    }
  }
  std::sort(vec.begin(), vec.end());  // (wid, pos) == stable-by-wid
}

// KmerAnalysis.cpp:82-106 + 134-166 (incl. support-counter carry-over)
static Seed longest_simple_pair(const char* f1, int64_t n1, const char* f2,
                                int64_t n2) {
  std::vector<std::pair<uint32_t, int64_t>> v1, v2;
  kmer_vec(f1, n1, v1);
  kmer_vec(f2, n2, v2);
  struct Triple { int64_t pd, rp, gp; };
  std::vector<Triple> pairs;
  for (auto& [wid, rpos] : v1) {
    auto it = std::lower_bound(
        v2.begin(), v2.end(), std::make_pair(wid, (int64_t)INT64_MIN));
    for (; it != v2.end() && it->first == wid; ++it)
      pairs.push_back({it->second - rpos, rpos, it->second});
  }
  std::sort(pairs.begin(), pairs.end(), [](const Triple& a, const Triple& b) {
    if (a.pd != b.pd) return a.pd < b.pd;
    if (a.rp != b.rp) return a.rp < b.rp;
    return a.gp < b.gp;
  });
  Seed seed;
  seed.simple = true;
  size_t num = pairs.size();
  int64_t max_len = 0;
  int64_t s = 1;
  size_t i = 0;
  while (i < num) {
    int64_t pd = pairs[i].pd;
    size_t j = i + 1;
    while (j < num && pairs[j].pd == pd) { ++s; ++j; }
    int64_t length = KMER + (pairs[j - 1].rp - pairs[i].rp);
    if (length > max_len && s > (length - KMER) / 2) {
      seed.rPos = (int32_t)pairs[i].rp;
      seed.gPos = pairs[i].gp;
      seed.rLen = seed.gLen = (int32_t)length;
      max_len = length;
      s = 1;
    }
    i = j;
  }
  return seed;
}

// ----------------------------------------------------- finalize stages

static inline bool by_gpos(const Seed& a, const Seed& b) {
  if (a.gPos != b.gPos) return a.gPos < b.gPos;
  return a.rPos < b.rPos;
}

static void remove_null(std::vector<Seed>& v) {
  v.erase(std::remove_if(v.begin(), v.end(),
                         [](const Seed& s) { return s.rLen == 0; }),
          v.end());
}

// AlignmentCandidates.cpp:817-842
static void remove_tandem(std::vector<Seed>& seeds) {
  if (seeds.size() < 2) return;
  std::map<int32_t, int> counts;
  for (auto& s : seeds) counts[s.rPos]++;
  bool tandem = false;
  for (auto& s : seeds)
    if (counts[s.rPos] > 1) { s.rLen = s.gLen = 0; tandem = true; }
  if (tandem) remove_null(seeds);
}

// AlignmentCandidates.cpp:844-902
static void remove_translocated(std::vector<Seed>& seeds) {
  size_t num = seeds.size();
  if (num < 2) return;
  std::vector<std::pair<int32_t, size_t>> vec(num);
  for (size_t i = 0; i < num; ++i) vec[i] = {seeds[i].rPos, i};
  std::stable_sort(vec.begin(), vec.end(),
                   [](const auto& a, const auto& b) { return a.first < b.first; });
  bool translocation = false;
  for (size_t i = 0; i < num; ++i) {
    if (vec[i].first != seeds[i].rPos) {
      translocation = true;
      size_t max_idx = vec[i].second;
      for (size_t j = i + 1; j <= max_idx && j < num; ++j)
        if (vec[j].second > max_idx) max_idx = vec[j].second;
      size_t j = max_idx;
      int64_t s1 = 0, s2 = 0;
      for (size_t k = i; k <= j; ++k) {
        if (k < vec[k].second) s1 += seeds[vec[k].second].rLen;
        else s2 += seeds[vec[k].second].rLen;
      }
      if (s1 > s2) {
        for (size_t k = i; k <= j; ++k)
          if (k > vec[k].second)
            seeds[vec[k].second].rLen = seeds[vec[k].second].gLen = 0;
      } else {
        for (size_t k = i; k <= j; ++k)
          if (k < vec[k].second)
            seeds[vec[k].second].rLen = seeds[vec[k].second].gLen = 0;
      }
      i = j;
    }
  }
  if (translocation) remove_null(seeds);
}

// AlignmentCandidates.cpp:596-624
static Seed reseed_region(const Ctx& C, const char* seq, int64_t r_begin,
                          int64_t r_end, int64_t lb, int64_t rb) {
  int64_t rl = r_end - r_begin;
  int64_t thr = (int64_t)(rl * 0.85);
  if (thr < 8) thr = 8;
  Seed seed = longest_simple_pair(seq + r_begin, rl,
                                  (const char*)C.ref + lb, rb - lb);
  if (seed.rLen >= thr) {
    seed.rPos += (int32_t)r_begin;
    seed.gPos += lb;
    seed.PosDiff = seed.gPos - seed.rPos;
  } else {
    seed.rLen = 0;
  }
  return seed;
}

// AlignmentCandidates.cpp:685-700
static void identify_missing(const Ctx& C, const char* seq,
                             std::vector<Seed>& seeds) {
  size_t num = seeds.size();
  bool added = false;
  for (size_t i = 1; i < num; ++i) {
    int32_t pd = (int32_t)(seeds[i].PosDiff - seeds[i - 1].PosDiff);
    int64_t rg = seeds[i].rPos - seeds[i - 1].rPos - seeds[i - 1].rLen;
    if (pd > 5 && rg > 20) {
      Seed s = reseed_region(C, seq,
                             seeds[i - 1].rPos + seeds[i - 1].rLen,
                             seeds[i].rPos,
                             seeds[i - 1].gPos + seeds[i - 1].gLen,
                             seeds[i].gPos);
      if (s.rLen > 0) { seeds.push_back(s); added = true; }
    }
  }
  if (added) std::sort(seeds.begin(), seeds.end(), by_gpos);
}

// AlignmentCandidates.cpp:385-467
static void best_gapped_partition(const Ctx& C, const char* seq, int64_t rg,
                                  const Seed& left, const Seed& right,
                                  int64_t* out_p, int64_t* out_lext,
                                  int64_t* out_rext) {
  const char* ref = (const char*)C.ref;
  int64_t r0 = left.rPos + left.rLen;
  std::vector<char> a1, a2, a3, a4;
  int64_t L1 = 0, L3 = 0;
  nw(seq + r0, rg, ref + left.gPos + left.gLen, rg, a1, a2, L1);
  {  // replace tailing genome gaps with the genome continuation (:399-400)
    int64_t i = L1 - 1;
    while (i >= 0 && a2[(size_t)i] == '-') --i;
    int64_t g = left.gPos + left.gLen + rg;
    for (int64_t k = i + 1; k < L1; ++k) a2[(size_t)k] = ref[g++];
  }
  std::vector<int64_t> rvec((size_t)rg + 1, 0);
  {
    int64_t p = 0, s = 0;
    for (int64_t k = 0; k < L1; ++k) {
      if (a1[(size_t)k] == a2[(size_t)k]) ++s;
      if (a1[(size_t)k] != '-') ++p;
      rvec[(size_t)p] = s;
    }
  }
  nw(seq + r0, rg, ref + right.gPos - rg, rg, a3, a4, L3);
  {  // replace heading genome gaps walking backwards (:424-425)
    int64_t i = 0;
    while (i < L3 && a4[(size_t)i] == '-') ++i;
    int64_t g = right.gPos - rg;
    for (int64_t k = i - 1; k >= 0; --k) a4[(size_t)k] = ref[g--];
  }
  std::vector<int64_t> lvec((size_t)rg + 1, 0);
  {
    int64_t p = 0, s = 0;
    for (int64_t k = L3 - 1; k >= 0; --k) {
      if (a3[(size_t)k] == a4[(size_t)k]) ++s;
      if (a3[(size_t)k] != '-') ++p;
      lvec[(size_t)(rg - p)] = s;
    }
  }
  int64_t max_score = 0, best_p = 0;
  for (int64_t k = 0; k <= rg; ++k) {
    int64_t sc = rvec[(size_t)k] + lvec[(size_t)k];
    if (sc > max_score) { max_score = sc; best_p = k; }
  }
  *out_p = best_p;
  *out_lext = 0;
  *out_rext = 0;
  if (max_score < (int64_t)(rg * 0.8) || (rg - max_score) > C.max_mismatch)
    return;
  {
    int64_t rext = 0, p = best_p, k = 0;
    while (p > 0) {
      if (a1[(size_t)k] != '-') --p;
      if (a2[(size_t)k] != '-') ++rext;
      ++k;
    }
    *out_rext = rext;
  }
  {
    int64_t lext = 0, p = rg - best_p, k = L3 - 1;
    while (p > 0) {
      if (a3[(size_t)k] != '-') --p;
      if (a4[(size_t)k] != '-') ++lext;
      --k;
    }
    *out_lext = lext;
  }
}

// AlignmentCandidates.cpp:547-575
static void fill_gaps(const Ctx& C, const char* seq, const Seed& left,
                      const Seed& right, std::vector<Seed>& out) {
  int64_t rg = right.rPos - (left.rPos + left.rLen);
  int64_t p, lext, rext;
  best_gapped_partition(C, seq, rg, left, right, &p, &lext, &rext);
  if (p > 0) {
    Seed s;
    s.rPos = left.rPos + left.rLen;
    s.gPos = left.gPos + left.gLen;
    s.rLen = (int32_t)p;
    s.gLen = (int32_t)rext;
    s.PosDiff = s.gPos - s.rPos;
    out.push_back(s);
  }
  int64_t rem = rg - p;
  if (rem > 0) {
    Seed s;
    s.rLen = (int32_t)rem;
    s.gLen = (int32_t)lext;
    s.rPos = right.rPos - s.rLen;
    s.gPos = right.gPos - s.gLen;
    s.PosDiff = s.gPos - s.rPos;
    out.push_back(s);
  }
}

// AlignmentCandidates.cpp:577-594
static void seed_extension(const Ctx& C, const char* seq,
                           std::vector<Seed>& seeds) {
  std::vector<Seed> added;
  size_t num = seeds.size();
  for (size_t i = 1; i < num; ++i) {
    int32_t pd = (int32_t)(seeds[i].PosDiff - seeds[i - 1].PosDiff);
    if (pd > C.min_intron &&
        seeds[i].rPos > seeds[i - 1].rPos + seeds[i - 1].rLen)
      fill_gaps(C, seq, seeds[i - 1], seeds[i], added);
  }
  if (!added.empty()) {
    for (auto& s : added) seeds.push_back(s);
    std::sort(seeds.begin(), seeds.end(), by_gpos);
  }
}

// AlignmentCandidates.cpp:702-730
static bool check_seq_fragment(const Ctx& C, int64_t lg, int64_t rg, int sh) {
  const uint8_t* ref = C.ref;
  if (sh > 0) {
    for (int i = 0; i < sh; ++i)
      if (ref[lg + i] != ref[rg + i]) return false;
  } else {
    int s = -sh;
    for (int i = 0; i < s; ++i)
      if (ref[lg - s + i] != ref[rg - s + i]) return false;
  }
  return true;
}

// AlignmentCandidates.cpp:732-756
static int identify_sj(const Ctx& C, int type, const Seed& left,
                       const Seed& right) {
  const uint8_t* ref = C.ref;
  const char* m = SJ_MOTIF[type];
  int32_t i = std::min(left.rLen, right.rLen);
  int32_t j = std::min(left.gLen, right.gLen);
  if (i < j) j = i;
  if (j > 9) j = 9;
  j <<= 1;
  int64_t lg = left.gPos + left.gLen;
  int64_t rg = right.gPos;
  int shift = 0, k = 0;
  for (; k <= j; ++k) {
    shift = SHIFT_ARR[k];
    if (shift == 0 || check_seq_fragment(C, lg, rg, shift)) {
      int64_t g1 = lg + shift;
      int64_t g2 = rg - 2 + shift;
      if (ref[g1] == (uint8_t)m[0] && ref[g1 + 1] == (uint8_t)m[1] &&
          ref[g2] == (uint8_t)m[3] && ref[g2 + 1] == (uint8_t)m[4])
        break;
    }
  }
  if (k > j) return 10;
  return shift;
}

// AlignmentCandidates.cpp:758-815
static int check_splice_junction(const Ctx& C, std::vector<Seed>& seeds) {
  size_t num = seeds.size();
  int min_cost = 1000, best_type = -1;
  std::vector<std::pair<size_t, int>> best_vec, vec;
  for (int type = 0; type < 4; ++type) {
    vec.clear();
    int mis = 0, c = 0;
    for (size_t i = 1; i < num; ++i) {
      if ((seeds[i].PosDiff - seeds[i - 1].PosDiff) > C.min_intron &&
          seeds[i - 1].simple && seeds[i].simple) {
        int sh = identify_sj(C, type, seeds[i - 1], seeds[i]);
        if (sh != 10) vec.emplace_back(i, sh);
        else ++mis;
        c += (sh < 0 ? -sh : sh);
      }
    }
    if (!vec.empty() && c < min_cost) {
      min_cost = c;
      best_type = type;
      best_vec = vec;
    }
    if (mis == 0) break;
  }
  if (best_type != -1) {
    for (auto& [i, sh] : best_vec) {
      seeds[i].acceptor = true;
      if (sh != 0) {
        seeds[i - 1].rLen += sh;
        seeds[i - 1].gLen += sh;
        seeds[i].rLen -= sh;
        seeds[i].gLen -= sh;
        seeds[i].rPos += sh;
        seeds[i].gPos += sh;
      }
    }
  }
  return best_type;
}

// AlignmentCandidates.cpp:904-954
static bool check_seed_overlapping(Seed& p1, Seed& p2) {
  bool master = true;
  int64_t overlap = (int64_t)p1.rPos + p1.rLen - p2.rPos;
  if (overlap > 0) {
    if (p1.rLen < p2.rLen) {
      master = false;
      if (p1.rLen > overlap) { p1.rLen -= (int32_t)overlap; p1.gLen = p1.rLen; }
      else p1.rLen = p1.gLen = 0;
    } else {
      if (p2.rLen > overlap) {
        p2.rPos += (int32_t)overlap;
        p2.gPos += overlap;
        p2.rLen -= (int32_t)overlap;
        p2.gLen = p2.rLen;
      } else p2.rLen = p2.gLen = 0;
    }
  }
  if (p1.rLen > 0 && p2.rLen > 0) {
    overlap = p1.gPos + p1.gLen - p2.gPos;
    if (overlap > 0) {
      if (p1.gLen < p2.gLen) {
        master = false;
        if (p1.rLen > overlap) { p1.rLen -= (int32_t)overlap; p1.gLen = p1.rLen; }
        else p1.rLen = p1.gLen = 0;
      } else {
        if (p2.rLen > overlap) {
          p2.rPos += (int32_t)overlap;
          p2.gPos += overlap;
          p2.rLen -= (int32_t)overlap;
          p2.gLen = p2.rLen;
        } else p2.rLen = p2.gLen = 0;
      }
    }
  }
  return master;
}

// AlignmentCandidates.cpp:963-999
static void check_overlapping_seeds(std::vector<Seed>& seeds) {
  size_t num = seeds.size();
  if (num < 2) return;
  bool null_seed = false;
  size_t i = 0;
  while (i < num) {
    if (seeds[i].rLen > 0) {
      int64_t r_end = (int64_t)seeds[i].rPos + seeds[i].rLen - 1;
      int64_t g_end = seeds[i].gPos + seeds[i].gLen - 1;
      size_t j = i + 1;
      while (j < num) {
        if (seeds[j].rLen == 0) { ++j; continue; }
        if (r_end < seeds[j].rPos && g_end < seeds[j].gPos) break;
        if (!check_seed_overlapping(seeds[i], seeds[j])) break;
        ++j;
      }
      if (seeds[i].rLen == 0) {
        null_seed = true;
        // backtrack to the previous surviving seed (:956-961)
        int64_t kk = (int64_t)i - 1;
        while (kk > 0 && seeds[(size_t)kk].rLen == 0) --kk;
        i = (size_t)(kk < 0 ? 0 : kk);
      } else {
        ++i;
      }
    } else {
      null_seed = true;
      ++i;
    }
  }
  if (null_seed) remove_null(seeds);
}

// AlignmentCandidates.cpp:1001-1035
static void identify_normal_pairs(std::vector<Seed>& seeds) {
  if (seeds.size() <= 1) return;
  check_overlapping_seeds(seeds);
  size_t num = seeds.size();
  std::vector<Seed> added;
  for (size_t i = 0; i + 1 < num; ++i) {
    size_t j = i + 1;
    if (seeds[j].rPos - seeds[i].rPos - seeds[i].rLen == 0) continue;
    int64_t rg = (int64_t)seeds[j].rPos - (seeds[i].rPos + seeds[i].rLen);
    if (rg < 0) rg = 0;
    int64_t gg = seeds[j].gPos - (seeds[i].gPos + seeds[i].gLen);
    if (gg < 0) gg = 0;
    else if (gg > 30 && gg > (rg << 1)) gg = 0;  // intron 'N'
    if (rg > 0 || gg > 0) {
      Seed s;
      s.rPos = seeds[i].rPos + seeds[i].rLen;
      s.gPos = seeds[i].gPos + seeds[i].gLen;
      s.PosDiff = s.gPos - s.rPos;
      s.rLen = (int32_t)rg;
      s.gLen = (int32_t)gg;
      added.push_back(s);
    }
  }
  if (!added.empty()) {
    std::vector<Seed> merged;
    merged.reserve(num + added.size());
    size_t a = 0, b = 0;
    while (a < num && b < added.size()) {
      if (by_gpos(added[b], seeds[a])) merged.push_back(added[b++]);
      else merged.push_back(seeds[a++]);
    }
    while (a < num) merged.push_back(seeds[a++]);
    while (b < added.size()) merged.push_back(added[b++]);
    seeds.swap(merged);
  }
}

// AlignmentCandidates.cpp:136-163
static bool check_coordinate_validity(const Ctx& C,
                                      const std::vector<Seed>& seeds) {
  int64_t g1 = 0, g2 = C.seq_len;
  for (auto& s : seeds)
    if (s.gLen > 0) { g1 = s.gPos; break; }
  for (auto it = seeds.rbegin(); it != seeds.rend(); ++it)
    if (it->gLen > 0) { g2 = it->gPos + it->gLen - 1; break; }
  int64_t G = C.genome;
  return !((g1 < G && G <= g2) || (g1 >= G && G > g2));
}

// AlignmentCandidates.cpp:83-116
static Coor gen_coordinate(const Ctx& C, bool first, int64_t g, int64_t ge) {
  Coor c;
  if (g < C.genome) {
    c.dir = first;
    size_t k = chr_lb(C, g);
    c.chr = C.kidx[k];
    c.gPos = g + 1 - C.chr_fwd[(size_t)c.chr];
  } else {
    c.dir = !first;
    size_t k = chr_lb(C, g);
    c.chr = C.kidx[k];
    c.gPos = C.keys[k] - ge + 1;
  }
  return c;
}

// --------------------------------------------- sequence-pair -> CIGAR

// tools.cpp:49-104
static int add_cigar_elements(const char* a1, const char* a2, int64_t L,
                              Cigar& cig) {
  char state = '*';
  int c = 0, score = 0;
  for (int64_t k = 0; k < L; ++k) {
    char op;
    if (a1[k] == '-') op = 'D';
    else if (a2[k] == '-') op = 'I';
    else {
      if (a1[k] == a2[k]) ++score;
      op = 'M';
    }
    if (op == state) ++c;
    else {
      if (c > 0) cig.emplace_back(c, state);
      c = 1;
      state = op;
    }
  }
  if (c > 0) cig.emplace_back(c, state);
  return score;
}

// tools.cpp:166-201
static bool check_local_quality(const char* a1, const char* a2, int64_t L) {
  int type = -1, n = 0, mis = 0, status = 0;
  for (int64_t k = 0; k < L; ++k) {
    int t;
    if (a1[k] == '-') t = 0;
    else if (a2[k] == '-') t = 1;
    else {
      ++n;
      if (a1[k] != a2[k]) ++mis;
      t = 2;
    }
    if (t != type) { type = t; ++status; }
  }
  return !(status >= 4 || (mis >= 3 && mis >= (int)(n * 0.3)));
}

static int count_mismatch(const char* f1, const uint8_t* f2, int64_t n) {
  int c = 0;
  for (int64_t i = 0; i < n; ++i)
    if ((uint8_t)f1[i] != f2[i]) ++c;
  return c;
}

// tools.cpp:130-164
static int process_normal_pair(const Ctx& C, const char* seq, Seed& sp,
                               Cigar& cig) {
  if (sp.PosDiff == -1) { cig.emplace_back(sp.rLen, 'S'); return 0; }
  if (sp.rLen == 0 || sp.gLen == 0) {
    if (sp.rLen > 0) cig.emplace_back(sp.rLen, 'I');
    else if (sp.gLen > 0) cig.emplace_back(sp.gLen, 'D');
    return 0;
  }
  const char* f1 = seq + sp.rPos;
  const uint8_t* f2 = C.ref + sp.gPos;
  if (sp.rLen == sp.gLen) {
    int n = count_mismatch(f1, f2, sp.rLen);
    if (n <= 2 && n <= (int)(sp.rLen * 0.2)) {
      cig.emplace_back(sp.rLen, 'M');
      return sp.rLen - n;
    }
  }
  int64_t L;
  nw(f1, sp.rLen, (const char*)f2, sp.gLen, g_scr.a1, g_scr.a2, L);
  return add_cigar_elements(g_scr.a1.data(), g_scr.a2.data(), L, cig);
}

// tools.cpp:203-249
static int process_head_pair(const Ctx& C, const char* seq, Seed& sp,
                             Cigar& cig) {
  const char* f1 = seq + sp.rPos;
  const uint8_t* f2 = C.ref + sp.gPos;
  if (sp.rLen == sp.gLen) {
    int n = count_mismatch(f1, f2, sp.rLen);
    if (n <= 2 && n <= (int)(sp.rLen * 0.2)) {
      cig.emplace_back(sp.rLen, 'M');
      return sp.rLen - n;
    }
  }
  int64_t L;
  nw(f1, sp.rLen, (const char*)f2, sp.gLen, g_scr.a1, g_scr.a2, L);
  const char* a1 = g_scr.a1.data();
  const char* a2 = g_scr.a2.data();
  if (!check_local_quality(a1, a2, L)) {
    cig.emplace_back(sp.rLen, 'S');
    return 0;
  }
  int64_t p = 0;
  while (p < L && a1[p] == '-') ++p;
  if (p > 0) {
    a1 += p; a2 += p; L -= p;
    sp.gPos += p;
    sp.gLen -= (int32_t)p;
  }
  int64_t q = 0;
  while (q < L && a2[q] == '-') ++q;
  if (q > 0) {
    a1 += q; a2 += q; L -= q;
    sp.rPos += (int32_t)q;
    sp.rLen -= (int32_t)q;
    cig.emplace_back((int)q, 'S');
  }
  return add_cigar_elements(a1, a2, L, cig);
}

// tools.cpp:251-300
static int process_tail_pair(const Ctx& C, const char* seq, Seed& sp,
                             Cigar& cig) {
  const char* f1 = seq + sp.rPos;
  const uint8_t* f2 = C.ref + sp.gPos;
  if (sp.rLen == sp.gLen) {
    int n = count_mismatch(f1, f2, sp.rLen);
    if (n <= 2 && n <= (int)(sp.rLen * 0.2)) {
      cig.emplace_back(sp.rLen, 'M');
      return sp.rLen - n;
    }
  }
  int64_t L;
  nw(f1, sp.rLen, (const char*)f2, sp.gLen, g_scr.a1, g_scr.a2, L);
  const char* a1 = g_scr.a1.data();
  const char* a2 = g_scr.a2.data();
  if (!check_local_quality(a1, a2, L)) {
    cig.emplace_back(sp.rLen, 'S');
    return 0;
  }
  int64_t c = 0, p = L - 1;
  while (p >= 0 && a1[p] == '-') { ++c; --p; }
  if (c > 0) {
    L -= c;
    sp.gLen -= (int32_t)c;
  }
  int64_t c2 = 0;
  p = L - 1;
  while (p >= 0 && a2[p] == '-') { ++c2; --p; }
  if (c2 > 0) {
    L -= c2;
    sp.rLen -= (int32_t)c2;
  }
  int score = add_cigar_elements(a1, a2, L, cig);
  if (c2 > 0) cig.emplace_back((int)c2, 'S');
  return score;
}

// AlignmentCandidates.cpp:37-61
static void cigar_string(const Cigar& cig, std::string& out) {
  out.clear();
  char state = 0;
  long c = 0;
  char buf[24];
  for (auto& [num, op] : cig) {
    if (op != state) {
      if (c > 0) { out += std::to_string(c); out += state; }
      c = num;
      state = op;
    } else {
      c += num;
    }
  }
  if (c > 0) { out += std::to_string(c); out += state; }
  (void)buf;
}

// AlignmentCandidates.cpp:1052-1064
static bool check_min_intron(const Cigar& cig, int min_intron) {
  for (auto& [num, op] : cig)
    if (op == 'N' && num < min_intron) return false;
  return true;
}

// ------------------------------------------------- GenMappingReport

// AlignmentCandidates.cpp:1079-1207
static void gen_mapping_report(const Ctx& C, bool first, Read& rd) {
  rd.score = 0;
  rd.best = 0;
  rd.sub = 0;
  rd.mis = 0;
  auto& av = rd.cans;
  rd.can_num = (int32_t)av.size();
  rd.reps.clear();
  if (rd.can_num > 0) {
    rd.reps.resize((size_t)rd.can_num);
    Cigar cig;
    std::string cigstr;
    for (size_t i = 0; i < av.size(); ++i) {
      Rep& rep = rd.reps[i];
      rep.sjtype = -1;
      rep.score = 0;
      rep.mate = av[i].mate;
      if (av[i].Score == 0) continue;
      auto& seeds = av[i].seeds;
      remove_tandem(seeds);
      remove_translocated(seeds);
      identify_missing(C, rd.seq, seeds);
      seed_extension(C, rd.seq, seeds);
      rep.sjtype = av[i].SJtype = check_splice_junction(C, seeds);
      identify_normal_pairs(seeds);

      size_t num = seeds.size();
      if (num > 1 && !check_coordinate_validity(C, seeds)) continue;
      cig.clear();
      int mis_num = 0;
      for (size_t j = 0; j < num; ++j) {
        Seed& sp = seeds[j];
        if (sp.rLen == 0 && sp.gLen == 0) continue;
        if (j > 0) {
          int64_t g = sp.gPos - (seeds[j - 1].gPos + seeds[j - 1].gLen);
          if (g > 0) cig.emplace_back((int)g, 'N');
        }
        if (sp.simple) {
          cig.emplace_back(sp.rLen, 'M');
          rep.score += sp.rLen;
        } else {
          int score;
          if (j == 0) score = process_head_pair(C, rd.seq, sp, cig);
          else if (j == num - 1) score = process_tail_pair(C, rd.seq, sp, cig);
          else score = process_normal_pair(C, rd.seq, sp, cig);
          rep.score += score;
          mis_num += sp.rLen - score;
        }
      }
      if (num > 0) {
        int32_t j0 = seeds[0].rPos;
        if (j0 > 0) cig.insert(cig.begin(), {j0, 'S'});
        int32_t j1 = rd.rlen - (seeds.back().rPos + seeds.back().rLen);
        if (j1 > 0) cig.emplace_back(j1, 'S');
      }
      if (mis_num > C.max_mismatch || cig.empty()) rep.score = 0;
      if (!check_min_intron(cig, C.min_intron)) rep.score = 0;
      if (rep.score > 0) {
        rep.coor = gen_coordinate(C, first, seeds[0].gPos,
                                  seeds.back().gPos + seeds.back().gLen - 1);
        if (rep.coor.gPos <= 0) rep.score = 0;
        else {
          if (seeds[0].gPos >= C.genome)
            std::reverse(cig.begin(), cig.end());
          cigar_string(cig, rep.coor.cigar);
        }
        if (rep.score > rd.score) {
          rd.best = (int32_t)i;
          rd.mis = mis_num;
          rd.sub = rd.score;
          rd.score = rep.score;
        } else if (rep.score == rd.score) {
          rd.sub = rd.score;
        }
      }
    }
  } else {
    rd.can_num = 1;
    rd.best = 0;
    rd.reps.assign(1, Rep());
  }
}

// ------------------------------------------------- pairing finalization

// Mapping.cpp:479-530
static void check_paired_final(const Ctx& C, Read& r1, Read& r2) {
  bool mated = false;
  if (r1.best != -1 && r2.best != -1)
    mated = r1.reps[(size_t)r1.best].mate == r2.best;
  if (!C.multi && mated) return;
  if (!mated && r1.score > 0 && r2.score > 0) {
    int s = 0;
    for (int32_t i = 0; i < r1.can_num; ++i) {
      int32_t j = r1.reps[(size_t)i].mate;
      if (r1.reps[(size_t)i].score > 0 && j != -1 &&
          r2.reps[(size_t)j].score > 0) {
        mated = true;
        int tot = r1.reps[(size_t)i].score + r2.reps[(size_t)j].score;
        if (s < tot) {
          s = tot;
          r1.best = i;
          r1.score = r1.reps[(size_t)i].score;
          r2.best = j;
          r2.score = r2.reps[(size_t)j].score;
        }
      }
    }
  }
  if (mated) {
    for (int32_t i = 0; i < r1.can_num; ++i) {
      Rep& rep = r1.reps[(size_t)i];
      int32_t j = rep.mate;
      if (rep.score != r1.score ||
          (j != -1 && r2.reps[(size_t)j].score != r2.score)) {
        rep.score = 0;
        rep.mate = -1;
      }
    }
  } else {
    for (auto& rep : r1.reps) {
      rep.mate = -1;
      if (rep.score > 0 && rep.score != r1.score) rep.score = 0;
    }
    for (auto& rep : r2.reps) {
      rep.mate = -1;
      if (rep.score > 0 && rep.score != r2.score) rep.score = 0;
    }
  }
}

// ------------------------------------------------- flags + MAPQ

// Mapping.cpp:74-99
static void set_single_flag(Read& rd) {
  if (rd.score > rd.sub) {
    Rep& rep = rd.reps[(size_t)rd.best];
    rep.flag = rep.coor.dir ? 0 : 0x10;
  } else if (rd.score > 0) {
    for (auto& rep : rd.reps)
      if (rep.score > 0) rep.flag = rep.coor.dir ? 0 : 0x10;
  } else {
    rd.reps[0].flag = 0x4;
  }
}

// Mapping.cpp:101-186
static void set_paired_flag(Read& r1, Read& r2) {
  if (r1.score > r1.sub && r2.score > r2.sub) {
    Rep& rep1 = r1.reps[(size_t)r1.best];
    rep1.flag = 0x41;
    Rep& rep2 = r2.reps[(size_t)r2.best];
    rep2.flag = 0x81;
    if (r2.best == rep1.mate) {
      rep1.flag |= 0x2;
      rep2.flag |= 0x2;
    }
    rep1.flag |= rep1.coor.dir ? 0x20 : 0x10;
    rep2.flag |= rep2.coor.dir ? 0x20 : 0x10;
    return;
  }
  if (r1.score > r1.sub) {
    Rep& rep = r1.reps[(size_t)r1.best];
    rep.flag = 0x41;
    rep.flag |= rep.coor.dir ? 0x20 : 0x10;
    int32_t j = rep.mate;
    if (j != -1 && r2.reps[(size_t)j].score > 0) rep.flag |= 0x2;
    else rep.flag |= 0x8;
  } else if (r1.score > 0) {
    for (auto& rep : r1.reps) {
      if (rep.score > 0) {
        rep.flag = 0x41;
        rep.flag |= rep.coor.dir ? 0x20 : 0x10;
        int32_t j = rep.mate;
        if (j != -1 && r2.reps[(size_t)j].score > 0) rep.flag |= 0x2;
        else rep.flag |= 0x8;
      }
    }
  } else {
    Rep& rep = r1.reps[0];
    rep.flag = 0x41 | 0x4;
    if (r2.score == 0) rep.flag |= 0x8;
    else rep.flag |= r2.reps[(size_t)r2.best].coor.dir ? 0x10 : 0x20;
  }

  if (r2.score > r2.sub) {
    Rep& rep = r2.reps[(size_t)r2.best];
    rep.flag = 0x81;
    rep.flag |= rep.coor.dir ? 0x20 : 0x10;
    int32_t i = rep.mate;
    if (i != -1 && r1.reps[(size_t)i].score > 0) rep.flag |= 0x2;
    else rep.flag |= 0x8;
  } else if (r2.score > 0) {
    for (auto& rep : r2.reps) {
      if (rep.score > 0) {
        rep.flag = 0x81;
        rep.flag |= rep.coor.dir ? 0x20 : 0x10;
        int32_t i = rep.mate;
        if (i != -1 && r1.reps[(size_t)i].score > 0) rep.flag |= 0x2;
        else rep.flag |= 0x8;
      }
    }
  } else {
    Rep& rep = r2.reps[0];
    rep.flag = 0x81 | 0x4;
    if (r1.score == 0) rep.flag |= 0x8;
    else rep.flag |= r1.reps[(size_t)r1.best].coor.dir ? 0x10 : 0x20;
  }
}

// Mapping.cpp:188-206
static void evaluate_mapq(Read& rd) {
  if (rd.score == 0 || rd.score == rd.sub) { rd.mapq = 0; return; }
  if (rd.sub == 0 || rd.score > rd.sub) { rd.mapq = MAX_MAPQ; return; }
  int n = 0;
  for (auto& rep : rd.reps)
    if (rep.score == rd.score) ++n;
  if (n >= 10) rd.mapq = 0;
  else if (n >= 4) rd.mapq = 1;
  else if (n == 3) rd.mapq = 2;
  else if (n == 2) rd.mapq = 3;
  else rd.mapq = MAX_MAPQ;
}

// ------------------------------------------------- SJ map (Mapping.cpp:532)

static void update_sj(Ctx& C, const Cand& can) {
  if (can.SJtype == -1) return;
  const auto& seeds = can.seeds;
  int64_t G2 = C.seq_len;
  for (size_t i = 1; i < seeds.size(); ++i) {
    if (!seeds[i].acceptor) continue;
    int64_t g1, g2;
    if (can.PosDiff < C.genome) {
      g1 = seeds[i - 1].gPos + seeds[i - 1].gLen;
      g2 = seeds[i].gPos - 1;
    } else {
      g1 = G2 - seeds[i].gPos;
      g2 = G2 - 1 - (seeds[i - 1].gPos + seeds[i - 1].gLen);
    }
    int64_t d = g2 - g1;
    if (d < 0) d = -d;
    if (d < C.min_intron) continue;
    auto key = std::make_pair(g1, g2);
    auto it = C.sj.find(key);
    if (it != C.sj.end()) it->second.second += 1;
    else C.sj[key] = {can.SJtype, 1};
  }
}

// ------------------------------------------------- SAM output

static int xs_idx(int sjtype, bool first) {
  if (sjtype == -1) return 0;
  bool plus = (sjtype == 0 || sjtype == 2);
  if (!first) plus = !plus;
  return plus ? 1 : 2;
}

static void append_seq(std::string& out, const char* s, int32_t n, bool rev) {
  if (!rev) { out.append(s, (size_t)n); return; }
  for (int32_t i = n - 1; i >= 0; --i) out += (char)COMP[(uint8_t)s[i]];
}

static void append_qual(std::string& out, const Read& rd, bool fastq,
                        bool rev) {
  if (!fastq) { out += '*'; return; }
  if (!rev) { out.append(rd.qual, (size_t)rd.qlen); return; }
  for (int32_t i = rd.qlen - 1; i >= 0; --i) out += rd.qual[i];
}

static void append_int(std::string& out, int64_t v) { out += std::to_string(v); }

static void emit_unmapped(Ctx& C, const Read& rd, bool fastq) {
  std::string& o = C.sam;
  o.append(rd.hdr, (size_t)rd.hlen);
  o += '\t';
  append_int(o, rd.reps[0].flag);
  o += "\t*\t0\t0\t*\t*\t0\t0\t";
  o.append(rd.seq, (size_t)rd.rlen);
  o += '\t';
  append_qual(o, rd, fastq, false);
  o += "\tAS:i:0\tXS:i:0\n";
}

static void emit_mapped(Ctx& C, const Read& rd, const Rep& rep, bool fastq,
                        bool first_read, bool seq_rev, bool qual_rev,
                        const char* rnext, int64_t pnext, int64_t dist) {
  std::string& o = C.sam;
  o.append(rd.hdr, (size_t)rd.hlen);
  o += '\t';
  append_int(o, rep.flag);
  o += '\t';
  o += C.chr_names[(size_t)rep.coor.chr];
  o += '\t';
  append_int(o, rep.coor.gPos);
  o += '\t';
  append_int(o, rd.mapq);
  o += '\t';
  o += rep.coor.cigar;
  o += '\t';
  o += rnext;
  o += '\t';
  append_int(o, pnext);
  o += '\t';
  append_int(o, dist);
  o += '\t';
  append_seq(o, rd.seq, rd.rlen, seq_rev);
  o += '\t';
  append_qual(o, rd, fastq, qual_rev);
  o += "\tNM:i:";
  append_int(o, rd.mis);
  o += "\tAS:i:";
  append_int(o, rd.score);
  o += "\tXS:i:";
  append_int(o, rd.sub);
  o += XS_A_STR[xs_idx(rep.sjtype, first_read)];
  o += '\n';
}

// Mapping.cpp:317-369
static void output_single(Ctx& C, const Read& rd, bool fastq) {
  if (rd.score == 0) {
    ++C.n_unmapped;
    emit_unmapped(C, rd, fastq);
    return;
  }
  if (C.unique && rd.mapq <= 3) return;
  if (rd.mapq == MAX_MAPQ) ++C.n_unique;
  for (int32_t i = rd.best; i < rd.can_num; ++i) {
    const Rep& rep = rd.reps[(size_t)i];
    if (rep.score == rd.score) {
      emit_mapped(C, rd, rep, fastq, true, !rep.coor.dir, !rep.coor.dir,
                  "*", 0, 0);
      if (!C.multi) break;
    }
  }
}

// Mapping.cpp:208-315
static void output_paired(Ctx& C, const Read& r1, const Read& r2, bool fastq) {
  // read 1
  if (r1.score == 0) {
    ++C.n_unmapped;
    emit_unmapped(C, r1, fastq);
  } else if (!C.unique || r1.mapq > 3) {
    if (r1.mapq == MAX_MAPQ) ++C.n_unique;
    for (int32_t i = r1.best; i < r1.can_num; ++i) {
      const Rep& rep = r1.reps[(size_t)i];
      if (rep.score > 0) {
        int32_t j = rep.mate;
        if (j != -1 && r2.reps[(size_t)j].score > 0) {
          int64_t dist = r2.reps[(size_t)j].coor.gPos - rep.coor.gPos +
                         (rep.coor.dir ? r2.rlen : -(int64_t)r1.rlen);
          if (i == r1.best) C.n_paired += 2;
          emit_mapped(C, r1, rep, fastq, true, !rep.coor.dir, !rep.coor.dir,
                      "=", r2.reps[(size_t)j].coor.gPos, dist);
        } else {
          emit_mapped(C, r1, rep, fastq, true, !rep.coor.dir, !rep.coor.dir,
                      "*", 0, 0);
        }
      }
      if (!C.multi) break;
    }
  }
  // read 2 (its seq was reverse-complemented at load)
  if (r2.score == 0) {
    ++C.n_unmapped;
    emit_unmapped(C, r2, fastq);
  } else if (!C.unique || r2.mapq > 3) {
    if (r2.mapq == MAX_MAPQ) ++C.n_unique;
    for (int32_t j = r2.best; j < r2.can_num; ++j) {
      const Rep& rep = r2.reps[(size_t)j];
      if (rep.score > 0) {
        int32_t i = rep.mate;
        if (i != -1 && r1.reps[(size_t)i].score > 0) {
          int64_t dist = -(r2.reps[(size_t)j].coor.gPos -
                           r1.reps[(size_t)i].coor.gPos +
                           (r1.reps[(size_t)i].coor.dir ? r2.rlen
                                                        : -(int64_t)r1.rlen));
          emit_mapped(C, r2, rep, fastq, false, rep.coor.dir, rep.coor.dir,
                      "=", r1.reps[(size_t)i].coor.gPos, dist);
        } else {
          emit_mapped(C, r2, rep, fastq, false, rep.coor.dir, rep.coor.dir,
                      "*", 0, 0);
        }
      }
      if (!C.multi) break;
    }
  }
}

// ------------------------------------------------- chunk driver

struct SeedInput {
  const int64_t* occ_off;   // (n_reads+1,)
  const int32_t* occ_rpos;  // per occurrence
  const int32_t* occ_len;
  const int64_t* occ_gpos;
};

static void build_seeds(const SeedInput& S, int64_t r, std::vector<Seed>& out) {
  int64_t a = S.occ_off[r], b = S.occ_off[r + 1];
  out.clear();
  out.reserve((size_t)(b - a));
  for (int64_t k = a; k < b; ++k) {
    Seed s;
    s.rPos = S.occ_rpos[k];
    s.rLen = s.gLen = S.occ_len[k];
    s.gPos = S.occ_gpos[k];
    s.PosDiff = s.gPos - s.rPos;
    s.simple = true;
    out.push_back(s);
  }
  std::sort(out.begin(), out.end(), by_gpos);
}

}  // namespace dartp

// ===================================================================== C ABI

using namespace dartp;

extern "C" {

void* dart_pipe_create(const uint8_t* ref_ascii, int64_t seq_len,
                       int64_t genome_size, const int64_t* chr_end_keys,
                       const int32_t* chr_end_idx, int32_t n_keys,
                       const char* chr_names_blob, const int64_t* chr_fwd_loc,
                       int32_t n_chr, int32_t max_gaps, int32_t max_intron,
                       int32_t min_intron, int32_t max_mismatch,
                       int32_t multi_hit, int32_t unique_only,
                       int32_t find_all_junction) {
  init_tables();
  Ctx* C = new Ctx();
  C->ref = ref_ascii;
  C->seq_len = seq_len;
  C->genome = genome_size;
  C->keys.assign(chr_end_keys, chr_end_keys + n_keys);
  C->kidx.assign(chr_end_idx, chr_end_idx + n_keys);
  const char* p = chr_names_blob;
  for (int32_t i = 0; i < n_chr; ++i) {
    const char* q = strchr(p, '\n');
    C->chr_names.emplace_back(p, (size_t)(q - p));
    p = q + 1;
  }
  C->chr_fwd.assign(chr_fwd_loc, chr_fwd_loc + n_chr);
  C->max_gaps = max_gaps;
  C->max_intron = max_intron;
  C->min_intron = min_intron;
  C->max_mismatch = max_mismatch;
  C->multi = multi_hit != 0;
  C->unique = unique_only != 0;
  C->all_sj = find_all_junction != 0;
  return C;
}

void dart_pipe_destroy(void* ctx) { delete (Ctx*)ctx; }

// Processes one chunk; returns the byte length of the SAM text, readable
// via dart_pipe_sam_ptr until the next call. counters_out: int64[3]
// {unique, unmapped, paired} cumulative deltas for this chunk.
int64_t dart_pipe_chunk(void* ctxp, int32_t n_reads, int32_t pair_end,
                        int32_t fastq, int32_t n_threads,
                        const char* seq_blob,
                        const int64_t* seq_off, const char* qual_blob,
                        const int64_t* qual_off, const char* hdr_blob,
                        const int64_t* hdr_off, const int64_t* occ_off,
                        const int32_t* occ_rpos, const int32_t* occ_len,
                        const int64_t* occ_gpos, int64_t* counters_out) {
  Ctx& C = *(Ctx*)ctxp;
  C.sam.clear();
  int64_t u0 = C.n_unique, m0 = C.n_unmapped, p0 = C.n_paired;
  SeedInput S{occ_off, occ_rpos, occ_len, occ_gpos};

  std::vector<Read> reads((size_t)n_reads);
  for (int32_t r = 0; r < n_reads; ++r) {
    Read& rd = reads[(size_t)r];
    rd.seq = seq_blob + seq_off[r];
    rd.rlen = (int32_t)(seq_off[r + 1] - seq_off[r]);
    if (qual_off) {
      rd.qual = qual_blob + qual_off[r];
      rd.qlen = (int32_t)(qual_off[r + 1] - qual_off[r]);
    }
    rd.hdr = hdr_blob + hdr_off[r];
    rd.hlen = (int32_t)(hdr_off[r + 1] - hdr_off[r]);
  }

  const bool paired = pair_end && n_reads % 2 == 0;
  const int32_t step = paired ? 2 : 1;

  // compute phase: per read (pair), no shared mutable state — splice
  // junctions and output run serially afterwards so results and the
  // junction table are identical at any thread count (unlike the
  // reference, whose SAM record order changes with -t > 1)
  auto compute = [&](int32_t i, std::vector<Seed>& seeds) {
    if (paired) {
      Read& r1 = reads[(size_t)i];
      Read& r2 = reads[(size_t)(i + 1)];
      build_seeds(S, i, seeds);
      gen_candidates(C, r1.rlen, seeds, r1.cans);
      build_seeds(S, i + 1, seeds);
      gen_candidates(C, r2.rlen, seeds, r2.cans);
      if (check_paired_cans(r1.cans, r2.cans))
        remove_unmated(r1.cans, r2.cans);
      remove_redundant(r1.cans);
      remove_redundant(r2.cans);
      gen_mapping_report(C, true, r1);
      gen_mapping_report(C, false, r2);
      check_paired_final(C, r1, r2);
      set_paired_flag(r1, r2);
      evaluate_mapq(r1);
      evaluate_mapq(r2);
    } else {
      Read& rd = reads[(size_t)i];
      build_seeds(S, i, seeds);
      gen_candidates(C, rd.rlen, seeds, rd.cans);
      remove_redundant(rd.cans);
      gen_mapping_report(C, true, rd);
      set_single_flag(rd);
      evaluate_mapq(rd);
    }
  };

  int nt = n_threads > 1 ? n_threads : 1;
  unsigned hw = std::thread::hardware_concurrency();
  if (hw && (unsigned)nt > hw) nt = (int)hw;
  if (nt > 1 && n_reads >= 2 * step) {
    std::atomic<int32_t> next{0};
    auto worker = [&]() {
      std::vector<Seed> seeds;
      while (true) {
        int32_t unit = next.fetch_add(64);
        int32_t lo = unit * step;
        if (lo >= n_reads) break;
        int32_t hi = std::min(lo + 64 * step, n_reads);
        for (int32_t i = lo; i < hi; i += step) compute(i, seeds);
      }
    };
    std::vector<std::thread> pool;
    for (int t = 1; t < nt; ++t) pool.emplace_back(worker);
    worker();
    for (auto& th : pool) th.join();
  } else {
    std::vector<Seed> seeds;
    for (int32_t i = 0; i < n_reads; i += step) compute(i, seeds);
  }

  // serial phase: junction accumulation + ordered output
  for (int32_t i = 0; i < n_reads; i += step) {
    Read& r1 = reads[(size_t)i];
    if (!r1.cans.empty() &&
        (r1.mapq == MAX_MAPQ || (C.all_sj && r1.score > 0)))
      update_sj(C, r1.cans[(size_t)r1.best]);
    if (paired) {
      Read& r2 = reads[(size_t)(i + 1)];
      if (!r2.cans.empty() &&
          (r2.mapq == MAX_MAPQ || (C.all_sj && r2.score > 0)))
        update_sj(C, r2.cans[(size_t)r2.best]);
    }
  }
  if (paired) {
    for (int32_t i = 0; i + 1 < n_reads; i += 2)
      output_paired(C, reads[(size_t)i], reads[(size_t)(i + 1)], fastq != 0);
  } else {
    for (int32_t i = 0; i < n_reads; ++i)
      output_single(C, reads[(size_t)i], fastq != 0);
  }

  counters_out[0] = C.n_unique - u0;
  counters_out[1] = C.n_unmapped - m0;
  counters_out[2] = C.n_paired - p0;
  return (int64_t)C.sam.size();
}

const char* dart_pipe_sam_ptr(void* ctxp) { return ((Ctx*)ctxp)->sam.data(); }

// Dump the splice-junction map as (g1, g2, type, count) int64 quadruples
// sorted by key; returns the number of junctions. Pointer valid until
// the next dump or destroy.
int64_t dart_pipe_sj_dump(void* ctxp, const int64_t** out) {
  Ctx& C = *(Ctx*)ctxp;
  C.sj_buf.clear();
  C.sj_buf.reserve(C.sj.size() * 4);
  for (auto& [key, val] : C.sj) {
    C.sj_buf.push_back(key.first);
    C.sj_buf.push_back(key.second);
    C.sj_buf.push_back(val.first);
    C.sj_buf.push_back(val.second);
  }
  *out = C.sj_buf.data();
  return (int64_t)C.sj.size();
}

}  // extern "C"
