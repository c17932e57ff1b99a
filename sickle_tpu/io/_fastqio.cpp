// Native host I/O: FASTQ line index + validate + pack, and trimmed-output
// assembly.  The replacement for the reference's
// GZReader/Batch/FQEntry/stringstream writer stack
// (/root/reference/src/GZReader.cpp, Batch.cpp, FQEntry.cpp,
// trim_single.cpp:374-427) — but single-pass, zero-per-line allocation,
// and operating entirely inside caller-provided reusable buffers (this
// container's page-fault cost makes fresh allocations ~300x slower than
// warm ones; see io/native.py).
//
// Exposed via ctypes (no pybind11 in this image).  All functions are
// thread-parallel over records where it pays.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

namespace {

void parallel_for(int64_t n, int n_threads, void (*body)(int64_t, int64_t, void*),
                  void* ctx) {
  if (n <= 0) return;
  int t = std::max(1, n_threads);
  if (t == 1 || n < 4096) {
    body(0, n, ctx);
    return;
  }
  std::vector<std::thread> threads;
  int64_t chunk = (n + t - 1) / t;
  for (int i = 0; i < t; i++) {
    int64_t lo = i * chunk, hi = std::min(n, lo + chunk);
    if (lo >= hi) break;
    threads.emplace_back([=] { body(lo, hi, ctx); });
  }
  for (auto& th : threads) th.join();
}

// Run fn(t) on t = 0..n_tasks-1 across n_threads OS threads.  Thread spawn
// costs ~25us here; callers only use this for >=ms-scale phases.
void run_tasks(int n_tasks, const std::function<void(int)>& fn) {
  if (n_tasks <= 1) {
    if (n_tasks == 1) fn(0);
    return;
  }
  std::vector<std::thread> threads;
  threads.reserve(n_tasks - 1);
  for (int t = 1; t < n_tasks; t++) threads.emplace_back([&fn, t] { fn(t); });
  fn(0);
  for (auto& th : threads) th.join();
}

#if defined(__AVX512F__) && defined(__AVX512BW__)
#define SK_NL_SIMD 1
#include <immintrin.h>

// Count '\n' in [p, p+n) — 64 B per vpcmpeqb+popcnt step.
static inline int64_t nl_count_simd(const uint8_t* p, int64_t n) {
  const __m512i nl = _mm512_set1_epi8('\n');
  int64_t c = 0, i = 0;
  for (; i + 64 <= n; i += 64) {
    __m512i v = _mm512_loadu_si512(p + i);
    c += __builtin_popcountll(_mm512_cmpeq_epi8_mask(v, nl));
  }
  for (; i < n; i++) c += (p[i] == '\n');
  return c;
}

// Write positions (+base) of up to `cap` newlines in [p, p+n) into idx;
// returns count written.  cmp mask + per-bit tzcnt emit.
static inline int64_t nl_index_simd(const uint8_t* p, int64_t n, int64_t cap,
                                    int64_t base, int64_t* idx) {
  const __m512i nl = _mm512_set1_epi8('\n');
  int64_t at = 0, i = 0;
  for (; i + 64 <= n && at + 64 <= cap; i += 64) {
    uint64_t m = _mm512_cmpeq_epi8_mask(_mm512_loadu_si512(p + i), nl);
    while (m) {
      idx[at++] = base + i + __builtin_ctzll(m);
      m &= m - 1;
    }
  }
  // tail (and the cap-limited remainder) byte by byte
  for (; i < n && at < cap; i++) {
    if (p[i] == '\n') idx[at++] = base + i;
  }
  return at;
}
#endif  // SK_NL_SIMD

// Parallel newline index over data[0, span): writes the byte positions of
// the first `cap` newlines (+ `base` each) into idx.  Returns the number
// written.  Two phases: per-thread counts -> prefix offsets -> writes.
int64_t index_newlines(const uint8_t* data, int64_t span, int64_t cap,
                       int64_t base, int64_t* idx, int n_threads) {
  int t = std::max(1, n_threads);
  if (span < (4 << 20)) t = 1;
  if (t == 1) {  // single pass: scan + write until cap
#ifdef SK_NL_SIMD
    return nl_index_simd(data, span, cap, base, idx);
#else
    const uint8_t* p = data;
    const uint8_t* hi = data + span;
    int64_t at = 0;
    while (at < cap && p < hi) {
      const uint8_t* q = static_cast<const uint8_t*>(memchr(p, '\n', hi - p));
      if (!q) break;
      idx[at++] = base + (q - data);
      p = q + 1;
    }
    return at;
#endif
  }
  std::vector<int64_t> cnt(t, 0);
  int64_t chunk = (span + t - 1) / t;
  run_tasks(t, [&](int i) {
    int64_t lo = std::min<int64_t>(span, i * chunk);
    int64_t hi = std::min<int64_t>(span, (i + 1) * chunk);
#ifdef SK_NL_SIMD
    cnt[i] = nl_count_simd(data + lo, hi - lo);
#else
    const uint8_t* p = data + lo;
    const uint8_t* e = data + hi;
    int64_t c = 0;
    while (p < e) {
      const uint8_t* q =
          static_cast<const uint8_t*>(memchr(p, '\n', e - p));
      if (!q) break;
      c++;
      p = q + 1;
    }
    cnt[i] = c;
#endif
  });
  std::vector<int64_t> off(t + 1, 0);
  for (int i = 0; i < t; i++) off[i + 1] = off[i] + cnt[i];
  int64_t total = std::min(off[t], cap);
  run_tasks(t, [&](int i) {
    int64_t at = off[i];
    if (at >= cap) return;
    int64_t lo = std::min<int64_t>(span, i * chunk);
    int64_t hi = std::min<int64_t>(span, (i + 1) * chunk);
    int64_t stop = std::min(off[i + 1], cap);
#ifdef SK_NL_SIMD
    nl_index_simd(data + lo, hi - lo, stop - at, base + lo, idx + at);
#else
    const uint8_t* p = data + lo;
    const uint8_t* e = data + hi;
    while (at < stop) {
      const uint8_t* q =
          static_cast<const uint8_t*>(memchr(p, '\n', e - p));
      idx[at++] = base + (q - data);
      p = q + 1;
    }
#endif
  });
  return total;
}

void atomic_min64(std::atomic<int64_t>& a, int64_t v) {
  int64_t cur = a.load(std::memory_order_relaxed);
  while (v < cur && !a.compare_exchange_weak(cur, v)) {
  }
}

}  // namespace

extern "C" {

// Count '\n' bytes exactly (AVX-512 popcount when available; multi-GB/s).
int64_t sk_count_newlines(const uint8_t* data, int64_t n) {
#ifdef SK_NL_SIMD
  return nl_count_simd(data, n);
#else
  int64_t count = 0;
  const uint8_t* p = data;
  const uint8_t* end = data + n;
  while (p < end) {
    const uint8_t* q = static_cast<const uint8_t*>(memchr(p, '\n', end - p));
    if (!q) break;
    count++;
    p = q + 1;
  }
  return count;
#endif
}

// Byte index of the k-th (1-based) '\n', or -1 if there are fewer than k.
int64_t sk_kth_newline(const uint8_t* data, int64_t n, int64_t k) {
  const uint8_t* p = data;
  const uint8_t* end = data + n;
  while (k > 0 && p < end) {
    const uint8_t* q = static_cast<const uint8_t*>(memchr(p, '\n', end - p));
    if (!q) return -1;
    if (--k == 0) return q - data;
    p = q + 1;
  }
  return -1;
}

// Count '\n' bytes (memchr loop; ~GB/s).
int64_t sk_count_lines(const uint8_t* data, int64_t n) {
  int64_t count = 0;
  const uint8_t* p = data;
  const uint8_t* end = data + n;
  while (p < end) {
    const uint8_t* q = static_cast<const uint8_t*>(memchr(p, '\n', end - p));
    if (!q) break;
    count++;
    p = q + 1;
  }
  // trailing unterminated line counts as a line
  if (n > 0 && data[n - 1] != '\n') count++;
  return count;
}

// One-pass parse + validate + pack, everything parallel.
//
// Pipeline inside one call:
//   1) parallel newline index (two-phase memchr) into starts4 as scratch,
//      self-extending from `scan_hint` bytes until 4*max_records lines or
//      EOF — streaming callers pass an estimate so a chunk never scans the
//      whole remaining mmap;
//   2) elementwise conversion newline-positions -> (line start, line len);
//   3) fused per-record validate + qual/seq row memcpy + NUL detection.
//
// Returns: 0 ok; 1 validation error (*err_record = first offending record,
// input order); 2 row length L too small (*out_max_len = required).
// out_flags bit0: some read's quality string contains a NUL byte (callers
// use this to keep the derive-lengths-from-zero-padding invariant honest).
// Trailing partial records (<4 lines) are ignored, matching the
// reference's 4-line batch alignment (src/GZReader.cpp:104-126).
// pack_rows=0 skips the row-matrix memcpy entirely (indexed host-cuts
// mode: sk_cuts_indexed reads records straight from `data`); the NUL
// scan then runs on the source span so qual_clean semantics (flags bit0)
// are unchanged, and rc=2 (undersized rows) cannot occur.
// at_eof=0: the buffer is a STREAMING WINDOW with more data to come —
// a trailing unterminated line is an incomplete record still being
// decoded, NOT the file's final line, so it must not be counted (a
// window cut mid-quality-line would otherwise validate as a short-qual
// record).  at_eof=1 (default, whole files): the reference's
// trailing-line semantics apply.
int sk_parse_pack2(const uint8_t* data, int64_t n, int64_t max_records,
                   int64_t scan_hint, int64_t L, int64_t* starts4,
                   int32_t* lens4, uint8_t* seq, uint8_t* qual,
                   int32_t* lengths, int64_t* out_n_records,
                   int64_t* out_max_len, int64_t* err_record,
                   int64_t* out_flags, int n_threads, int need_seq,
                   int pack_rows, int at_eof) {
  int64_t max_lines = max_records * 4;
  if (scan_hint <= 0 && n > (8 << 20)) {
    // no caller estimate on a large buffer: sniff the head for the
    // average line length so the count phase never walks the whole mmap
    int64_t sniff = std::min<int64_t>(n, 1 << 20);
    int64_t nl = sk_count_newlines(data, sniff);
    if (nl >= 8) scan_hint = max_lines * (sniff / nl + 2) * 9 / 8;
  }
  int64_t span = (scan_hint <= 0) ? n : std::min(scan_hint, n);
  int64_t n_nl = index_newlines(data, span, max_lines, 0, starts4, n_threads);
  while (n_nl < max_lines && span < n) {
    // extend: estimate the remaining bytes from the observed line length
    int64_t avg = n_nl ? (starts4[n_nl - 1] + 1) / n_nl : 256;
    int64_t need = (max_lines - n_nl) * std::max<int64_t>(avg, 16) * 5 / 4;
    int64_t new_span = std::min(n, span + std::max(need, span));
    n_nl += index_newlines(data + span, new_span - span, max_lines - n_nl,
                           span, starts4 + n_nl, n_threads);
    span = new_span;
  }
  int64_t n_lines = n_nl;
  if (at_eof && span == n && n > 0 && data[n - 1] != '\n' &&
      n_lines < max_lines) {
    starts4[n_lines++] = n;  // trailing unterminated line
  }
  int64_t n_records = n_lines / 4;
  *out_n_records = n_records;
  *out_max_len = 0;
  *out_flags = 0;
  if (n_records == 0) return 0;
  int64_t used = 4 * n_records;

  // newline positions -> line lengths (reads starts4, writes lens4) ...
  struct ConvCtx {
    const int64_t* nl;
    int32_t* lens;
  } conv{starts4, lens4};
  parallel_for(used, n_threads,
               [](int64_t lo, int64_t hi, void* v) {
                 ConvCtx* c = static_cast<ConvCtx*>(v);
                 for (int64_t i = lo; i < hi; i++) {
                   int64_t start = i ? c->nl[i - 1] + 1 : 0;
                   c->lens[i] = static_cast<int32_t>(c->nl[i] - start);
                 }
               },
               &conv);
  // ... then line starts, elementwise in place (starts4[i] only reads i)
  struct Conv2Ctx {
    int64_t* nl;
    const int32_t* lens;
  } conv2{starts4, lens4};
  parallel_for(used, n_threads,
               [](int64_t lo, int64_t hi, void* v) {
                 Conv2Ctx* c = static_cast<Conv2Ctx*>(v);
                 for (int64_t i = lo; i < hi; i++) c->nl[i] -= c->lens[i];
               },
               &conv2);

  // fused validate + pack + NUL scan
  std::atomic<int64_t> err(INT64_MAX);
  std::atomic<int> has_nul(0);
  int nt = std::max(1, n_threads);
  if (n_records < 4096) nt = 1;
  std::vector<int64_t> local_max(nt, 0);
  int64_t rchunk = (n_records + nt - 1) / nt;
  run_tasks(nt, [&](int ti) {
    int64_t lo = ti * rchunk, hi = std::min<int64_t>(n_records, lo + rchunk);
    int64_t mx = 0;
    bool nul = false;
    for (int64_t r = lo; r < hi; r++) {
      int32_t name_len = lens4[4 * r];
      int32_t seq_len = lens4[4 * r + 1];
      int32_t qual_len = lens4[4 * r + 3];
      if (name_len <= 1 || data[starts4[4 * r]] != '@' || seq_len < 1 ||
          qual_len < 1 || seq_len != qual_len) {
        atomic_min64(err, r);
        continue;
      }
      if (seq_len > mx) mx = seq_len;
      if (pack_rows > 0) {  // -1 = indexed host-bound: no rows, no NUL scan
        if (seq_len > L) continue;  // undersized row buffer; caller retries
        uint8_t* qrow = qual + r * L;
        memcpy(qrow, data + starts4[4 * r + 3], seq_len);
        if (!nul && memchr(qrow, 0, seq_len)) nul = true;
        memset(qrow + seq_len, 0, L - seq_len);
        if (need_seq) {
          uint8_t* srow = seq + r * L;
          memcpy(srow, data + starts4[4 * r + 1], seq_len);
          memset(srow + seq_len, 0, L - seq_len);
        }
      } else if (pack_rows == 0 && !nul &&
                 memchr(data + starts4[4 * r + 3], 0, seq_len)) {
        // pack_rows < 0: indexed HOST-BOUND chunk — lengths come from
        // the line index, qual_clean is never consulted, skip the scan
        nul = true;
      }
      lengths[r] = seq_len;
    }
    local_max[ti] = mx;
    if (nul) has_nul.store(1, std::memory_order_relaxed);
  });
  int64_t max_len = 0;
  for (int ti = 0; ti < nt; ti++) max_len = std::max(max_len, local_max[ti]);
  *out_max_len = max_len;
  if (err.load() != INT64_MAX) {
    *err_record = err.load();
    return 1;
  }
  if (pack_rows > 0 && max_len > L) return 2;
  *out_flags = has_nul.load() ? 1 : 0;
  return 0;
}

// --- host cuts kernel: exact sliding-window trimming on the CPU --------
//
// Scalar-per-read transcription of the oracle semantics (SURVEY.md §2.3,
// reference src/trim.cpp:3-116) over a packed [B, L] row matrix.  This is
// the engine's HOST compute path: the hybrid dispatcher feeds it the
// chunks it routes away from the device, and non-JAX hosts can run the
// whole pipeline through it.  ~2*len integer ops per read, parallel over
// rows; a 2-core container sustains millions of reads/s.
//
// Quality-range semantics are the reference's LAZY ones: a char errors
// only if the scan touches it.  The loop runs unchecked, recording the
// touched extent (= min(i_break + w, len)); the row's bytes [0, extent)
// are then scanned for out-of-range chars.  Sound because the loop's
// trajectory up to the first touch of position p depends only on
// positions < p (the window ending at p is the first to read it), so an
// unchecked run reaches/misses p exactly as the checked reference does.
// strict=1 scans the whole read instead (--strict).
//
// out_bad[r] = first flagged 0-based position, else 0x3FFFFFFF (BIG) —
// same contract as the device kernels; the caller re-derives the exact
// reference message scalar-side for flagged rows (engine._check_quality).

struct CutsCtx {
  const uint8_t* seq;   // nullable when !trunc_n
  const uint8_t* qual;
  const int32_t* lengths;
  int64_t L;
  int qoffset, qmin, qmax, t, lthr;
  int no_fiveprime, trunc_n, n_lower_first, strict;
  int32_t* five;
  int32_t* three;
  int32_t* bad;
  const uint8_t* qual_hard_end;  // SIMD may not read at/past this pointer
};

// Per-read scalar core: direct transcription of the reference loop
// (src/trim.cpp:3-116 semantics; see block comment above).  q/s point at
// this read's quality/sequence bytes; s may be null when !trunc_n.
static inline void cut_read_scalar(const uint8_t* q, const uint8_t* s,
                                   int32_t len, const CutsCtx* c,
                                   int32_t* out_five, int32_t* out_three,
                                   int32_t* out_bad) {
  const int t = c->t;
  int32_t w = len / 10;  // int(0.1*len) == len/10 exactly (ops/trim.py)
  if (w == 0) w = len;
  int32_t five = 0, three = len;
  bool found = false;
  int64_t twl = (int64_t)t * w;
  int64_t total = 0;
  for (int32_t j = 0; j < w; j++) total += q[j] - c->qoffset;
  int32_t i = 0;
  const int32_t i_end = len - w;  // inclusive
  for (;; i++) {
    if (!c->no_fiveprime && !found && total >= twl) {
      for (int32_t j = i; j < i + w; j++) {
        if (q[j] - c->qoffset >= t) {
          five = j;
          break;
        }
      }
      found = true;
    }
    if (total < twl && (found || c->no_fiveprime)) {
      for (int32_t j = i; j < i + w; j++) {
        if (q[j] - c->qoffset < t) {
          three = j;
          break;
        }
      }
      break;
    }
    if (i >= i_end) break;
    total -= q[i] - c->qoffset;
    if (i + w < len) total += q[i + w] - c->qoffset;
  }
  // touched extent: initial window [0, w) plus one char per slide;
  // at loop exit index i the extent is min(i + w, len)
  int32_t extent = c->strict ? len : std::min(i + w, len);
  for (int32_t j = 0; j < extent; j++) {
    if (q[j] < c->qmin || q[j] > c->qmax) {
      *out_bad = j;
      break;
    }
  }
  if (c->trunc_n && s) {
    const void* pa = memchr(s, c->n_lower_first ? 'n' : 'N', len);
    const void* pb = memchr(s, c->n_lower_first ? 'N' : 'n', len);
    const void* p = pa ? pa : pb;
    if (p) three = (int32_t)((const uint8_t*)p - s) - 1;
  }
  if ((!found && !c->no_fiveprime) || (three - five < c->lthr)) {
    *out_five = -1;
    *out_three = -1;
  } else {
    *out_five = five;
    *out_three = three;
  }
}

#if defined(__SSE4_1__) && defined(__BMI2__)
#define SK_CUTS_SIMD 1
#include <immintrin.h>

// Vectorized per-read core, exact-equivalent reformulation of the loop
// above (property-tested against the oracle in tests/test_trim_host.py):
//
//   raw u16 prefix sums P[0..len]  (8 lanes/step, SSE)
//   W[i] = P[i+w] - P[i]           (the reference's rolling window sum
//                                   plus qoffset*w, folded into thr)
//   mask bit i = (W[i] >= thr)     (subs_epu16 + movemask + pext)
//   i5 = first set bit; i3 = first CLEAR bit at index >= i5
//   five/three = short scalar scans inside the trigger windows
//   range check = 16-wide in-range compare over the touched extent
//
// Returns false when this read must take the scalar path (length out of
// the u16-safe range, a degenerate threshold, or the trailing-bytes
// overread would cross qual_hard_end).
static inline bool cut_read_simd(const uint8_t* q, const uint8_t* s,
                                 int32_t len, const CutsCtx* c,
                                 int32_t* out_five, int32_t* out_three,
                                 int32_t* out_bad) {
  if (len < 10 || len > 255) return false;
  const int32_t w = len / 10;  // >= 1 and < len here
  const int64_t thr64 = ((int64_t)c->t + c->qoffset) * w;
  if (thr64 > 60000) return false;  // unreachable thresholds: scalar
  const uint16_t thr = thr64 > 0 ? (uint16_t)thr64 : 0;
  // prefix/range loops overread up to 15 bytes past q+len
  if (c->qual_hard_end && q + len + 16 > c->qual_hard_end) return false;

  // element threshold: q[j] - qoffset >= t  <=>  q[j] >= te
  const int64_t te64 = (int64_t)c->t + c->qoffset;
  const int32_t te = te64 < 0 ? 0 : (te64 > 256 ? 256 : (int32_t)te64);

  // all-high early-out: every char >= te means W[0] already triggers 5'
  // (five = 0) and no window can trigger 3' (three = len) — the common
  // case at the default q=20 on healthy reads skips the whole prefix
  // machinery.  One cmp+movemask sweep doubles as the range check's
  // lower bound when te >= qmin.
  if (te >= 1 && te <= 255 && !c->no_fiveprime) {
    const __m128i tev = _mm_set1_epi8(char(uint8_t(te)));
    bool all_hi = true;
    int32_t j = 0;
    for (; j + 16 <= len && all_hi; j += 16) {
      __m128i qv = _mm_loadu_si128(reinterpret_cast<const __m128i*>(q + j));
      // unsigned q >= te  <=>  max_epu8(q, te) == q
      __m128i ge = _mm_cmpeq_epi8(_mm_max_epu8(qv, tev), qv);
      if ((uint32_t)_mm_movemask_epi8(ge) != 0xFFFFu) all_hi = false;
    }
    for (; j < len && all_hi; j++) {
      if (q[j] < te) all_hi = false;
    }
    if (all_hi) {
      // range check over the whole read (extent == len here)
      const __m128i qminv2 = _mm_set1_epi8(char(uint8_t(c->qmin)));
      const __m128i qmaxv2 = _mm_set1_epi8(char(uint8_t(c->qmax)));
      const __m128i z2 = _mm_setzero_si128();
      for (int32_t k = 0; k < len; k += 16) {
        __m128i qv =
            _mm_loadu_si128(reinterpret_cast<const __m128i*>(q + k));
        __m128i ok = _mm_and_si128(
            _mm_cmpeq_epi8(_mm_subs_epu8(qminv2, qv), z2),
            _mm_cmpeq_epi8(_mm_subs_epu8(qv, qmaxv2), z2));
        uint32_t m = ~(uint32_t)_mm_movemask_epi8(ok) & 0xFFFFu;
        if (len - k < 16) m &= ((uint32_t)1 << (len - k)) - 1;
        if (m) {
          *out_bad = k + (int32_t)__builtin_ctz(m);
          break;
        }
      }
      if (c->trunc_n && s) {
        const void* pa = memchr(s, c->n_lower_first ? 'n' : 'N', len);
        const void* pb = memchr(s, c->n_lower_first ? 'N' : 'n', len);
        const void* p2 = pa ? pa : pb;
        int32_t three0 = len;
        if (p2) three0 = (int32_t)((const uint8_t*)p2 - s) - 1;
        if (three0 < c->lthr) {  // five == 0
          *out_five = -1;
          *out_three = -1;
        } else {
          *out_five = 0;
          *out_three = three0;
        }
        return true;
      }
      *out_five = 0;
      *out_three = len;  // len >= lthr was checked by the caller
      return true;
    }
  }

  alignas(16) uint16_t P[256 + 16];
  P[0] = 0;
  __m128i carry = _mm_setzero_si128();
  const __m128i zero = _mm_setzero_si128();
  for (int32_t j = 0; j < len; j += 8) {
    __m128i v = _mm_cvtepu8_epi16(_mm_loadl_epi64(
        reinterpret_cast<const __m128i*>(q + j)));
    v = _mm_add_epi16(v, _mm_slli_si128(v, 2));
    v = _mm_add_epi16(v, _mm_slli_si128(v, 4));
    v = _mm_add_epi16(v, _mm_slli_si128(v, 8));
    v = _mm_add_epi16(v, carry);
    _mm_storeu_si128(reinterpret_cast<__m128i*>(P + 1 + j), v);
    carry = _mm_set1_epi16((short)_mm_extract_epi16(v, 7));
  }

  const int32_t n_i = len - w + 1;  // window positions [0, len-w]
  uint64_t bits[4] = {0, 0, 0, 0};
  const __m128i thrv = _mm_set1_epi16((short)thr);
  for (int32_t i = 0; i < n_i; i += 8) {
    __m128i a = _mm_loadu_si128(reinterpret_cast<const __m128i*>(P + i + w));
    __m128i b = _mm_loadu_si128(reinterpret_cast<const __m128i*>(P + i));
    __m128i Wv = _mm_sub_epi16(a, b);
    // W >= thr  <=>  saturating(thr - W) == 0
    __m128i ge = _mm_cmpeq_epi16(_mm_subs_epu16(thrv, Wv), zero);
    uint32_t m = _pext_u32((uint32_t)_mm_movemask_epi8(ge), 0xAAAAu);
    bits[i >> 6] |= (uint64_t)m << (i & 63);
  }
  // clear bits at/after n_i so inverted searches stay in range
  {
    int32_t word = n_i >> 6, off = n_i & 63;
    if (off) bits[word++] &= ((uint64_t)1 << off) - 1;
    for (; word < 4; word++) bits[word] = 0;
  }

  int32_t five = 0, three = len;
  bool found = false;
  int32_t i5 = -1;
  if (!c->no_fiveprime) {
    for (int32_t word = 0; word < 4 && i5 < 0; word++) {
      if (bits[word]) i5 = (word << 6) + __builtin_ctzll(bits[word]);
    }
    if (i5 >= 0) {
      found = true;
      for (int32_t j = i5; j < i5 + w; j++) {
        if (q[j] >= te) {  // q - qoffset >= t (te pre-clamped)
          five = j;
          break;
        }
      }
    }
  }
  // 3' trigger: first window index >= max(i5, 0) with W < thr, only
  // meaningful once 5' fired (or with -x); W[i5] >= thr, so searching
  // from i5 never lands on i5 itself — same order as the scalar loop
  int32_t i3 = -1;
  if (found || c->no_fiveprime) {
    int32_t start = i5 < 0 ? 0 : i5;
    for (int32_t word = start >> 6; word < 4 && i3 < 0; word++) {
      uint64_t inv = ~bits[word];
      if (word == (start >> 6) && (start & 63)) {
        inv &= ~(((uint64_t)1 << (start & 63)) - 1);
      }
      int32_t base = word << 6;
      // restrict to valid window positions
      if (base >= n_i) break;
      if (base + 64 > n_i) inv &= ((uint64_t)1 << (n_i - base)) - 1;
      if (inv) i3 = base + __builtin_ctzll(inv);
    }
    if (i3 >= 0) {
      for (int32_t j = i3; j < i3 + w; j++) {
        if (q[j] < te) {  // q - qoffset < t
          three = j;
          break;
        }
      }
    }
  }
  // loop exit index: i3 when the 3' trigger broke the slide, else i_end
  int32_t exit_i = i3 >= 0 ? i3 : (len - w);
  int32_t extent = c->strict ? len : std::min(exit_i + w, len);

  // range check over the touched extent, 16 bytes at a time
  const __m128i qminv = _mm_set1_epi8((char)(uint8_t)c->qmin);
  const __m128i qmaxv = _mm_set1_epi8((char)(uint8_t)c->qmax);
  for (int32_t j = 0; j < extent; j += 16) {
    __m128i qv = _mm_loadu_si128(reinterpret_cast<const __m128i*>(q + j));
    // in-range  <=>  (qmin <=u q) && (q <=u qmax), via saturating subs
    __m128i ok = _mm_and_si128(
        _mm_cmpeq_epi8(_mm_subs_epu8(qminv, qv), zero),
        _mm_cmpeq_epi8(_mm_subs_epu8(qv, qmaxv), zero));
    uint32_t m = ~(uint32_t)_mm_movemask_epi8(ok) & 0xFFFFu;
    if (extent - j < 16) m &= ((uint32_t)1 << (extent - j)) - 1;
    if (m) {
      *out_bad = j + (int32_t)__builtin_ctz(m);
      break;
    }
  }

  if (c->trunc_n && s) {
    const void* pa = memchr(s, c->n_lower_first ? 'n' : 'N', len);
    const void* pb = memchr(s, c->n_lower_first ? 'N' : 'n', len);
    const void* p = pa ? pa : pb;
    if (p) three = (int32_t)((const uint8_t*)p - s) - 1;
  }
  if ((!found && !c->no_fiveprime) || (three - five < c->lthr)) {
    *out_five = -1;
    *out_three = -1;
  } else {
    *out_five = five;
    *out_three = three;
  }
  return true;
}
#endif  // SK_CUTS_SIMD

// Dispatch one read: short/padding filter, then SIMD core with scalar
// fallback (exact same results either way).
static inline void cut_read(const uint8_t* q, const uint8_t* s, int32_t len,
                            const CutsCtx* c, int32_t* out_five,
                            int32_t* out_three, int32_t* out_bad) {
  const int32_t BIGC = 0x3FFFFFFF;
  *out_bad = BIGC;
  // upfront length filter (trim.cpp:21-26): before any quality decode,
  // so short rows (and padding rows, len 0) never touch chars — but
  // strict mode checks the WHOLE read regardless, matching the device
  // path's conservative flag (ops/trim.decode_check)
  if (len < c->lthr || len <= 0) {
    *out_five = -1;
    *out_three = -1;
    if (c->strict && len > 0) {
      for (int32_t j = 0; j < len; j++) {
        if (q[j] < c->qmin || q[j] > c->qmax) {
          *out_bad = j;
          break;
        }
      }
    }
    return;
  }
#ifdef SK_CUTS_SIMD
  static const bool no_simd = getenv("SICKLE_TPU_NO_SIMD_CUTS") != nullptr;
  if (!no_simd &&
      cut_read_simd(q, s, len, c, out_five, out_three, out_bad)) {
    return;
  }
#endif
  cut_read_scalar(q, s, len, c, out_five, out_three, out_bad);
}

static void cuts_body(int64_t lo, int64_t hi, void* vctx) {
  const CutsCtx* c = static_cast<const CutsCtx*>(vctx);
  const int64_t L = c->L;
  for (int64_t r = lo; r < hi; r++) {
    cut_read(c->qual + r * L,
             (c->trunc_n && c->seq) ? c->seq + r * L : nullptr,
             c->lengths[r], c, c->five + r, c->three + r, c->bad + r);
  }
}

struct AssembleCtx {
  const uint8_t* data;
  const int64_t* name_start;
  const int32_t* name_len;
  const int64_t* seq_start;
  const int64_t* comment_start;
  const int32_t* comment_len;
  const int64_t* qual_start;
  const int32_t* five;
  const int32_t* three;
  const uint8_t* n_mask;  // nullable
  int rewrite_comment;
  uint8_t lowq;
  const int64_t* out_offsets;
  uint8_t* out;
};

static void assemble_body(int64_t lo, int64_t hi, void* vctx) {
  AssembleCtx* c = static_cast<AssembleCtx*>(vctx);
  for (int64_t r = lo; r < hi; r++) {
    uint8_t* o = c->out + c->out_offsets[r];
    int32_t nl = c->name_len[r];
    memcpy(o, c->data + c->name_start[r], nl);
    o += nl;
    *o++ = '\n';
    bool nrec = c->n_mask && c->n_mask[r];
    if (nrec) {
      *o++ = 'N';
    } else {
      int32_t cut = c->three[r] - c->five[r];
      memcpy(o, c->data + c->seq_start[r] + c->five[r], cut);
      o += cut;
    }
    *o++ = '\n';
    if (c->rewrite_comment) {
      *o++ = '+';
    } else {
      int32_t cl = c->comment_len[r];
      memcpy(o, c->data + c->comment_start[r], cl);
      o += cl;
    }
    *o++ = '\n';
    if (nrec) {
      *o++ = c->lowq;
    } else {
      int32_t cut = c->three[r] - c->five[r];
      memcpy(o, c->data + c->qual_start[r] + c->five[r], cut);
      o += cut;
    }
    *o++ = '\n';
  }
}

// Host cuts kernel (see CutsCtx block comment).  seq may be null when
// !trunc_n.  Writes five/three (-1/-1 = discard) and bad (first flagged
// quality position or 0x3FFFFFFF) for every row.
void sk_cuts(const uint8_t* seq, const uint8_t* qual, const int32_t* lengths,
             int64_t B, int64_t L, int qoffset, int qmin, int qmax, int t,
             int lthr, int no_fiveprime, int trunc_n, int n_lower_first,
             int strict, int32_t* five, int32_t* three, int32_t* bad,
             int n_threads) {
  CutsCtx ctx{seq,  qual,    lengths, L,       qoffset,       qmin,
              qmax, t,       lthr,    no_fiveprime, trunc_n,  n_lower_first,
              strict, five,  three,   bad,     qual + B * L};
  parallel_for(B, n_threads, cuts_body, &ctx);
}

// Indexed host cuts: read each record's seq/qual bytes STRAIGHT from the
// source buffer via the parse line index (starts4/lens4 from
// sk_parse_pack2) — no packed row matrix, so a host-only pipeline skips
// ~2 bytes of memory traffic per input byte (the row memcpy and its
// later re-read).  Same exact semantics as sk_cuts.
struct IdxCutsCtx {
  const uint8_t* data;
  const int64_t* starts4;
  const int32_t* lens4;
  CutsCtx base;  // seq/qual/lengths/L unused; params + outputs used
};

static void idx_cuts_body(int64_t lo, int64_t hi, void* vctx) {
  IdxCutsCtx* c = static_cast<IdxCutsCtx*>(vctx);
  for (int64_t r = lo; r < hi; r++) {
    int32_t len = c->lens4[4 * r + 1];
    cut_read(c->data + c->starts4[4 * r + 3],
             c->base.trunc_n ? c->data + c->starts4[4 * r + 1] : nullptr,
             len, &c->base, c->base.five + r, c->base.three + r,
             c->base.bad + r);
  }
}

void sk_cuts_indexed(const uint8_t* data, int64_t data_size,
                     const int64_t* starts4, const int32_t* lens4,
                     int64_t n_records, int qoffset,
                     int qmin, int qmax, int t, int lthr, int no_fiveprime,
                     int trunc_n, int n_lower_first, int strict,
                     int32_t* five, int32_t* three, int32_t* bad,
                     int n_threads) {
  IdxCutsCtx ctx{data, starts4, lens4,
                 CutsCtx{nullptr, nullptr, nullptr, 0, qoffset, qmin, qmax,
                         t, lthr, no_fiveprime, trunc_n, n_lower_first,
                         strict, five, three, bad, data + data_size}};
  parallel_for(n_records, n_threads, idx_cuts_body, &ctx);
}

// Emit trimmed records at precomputed output offsets (parallel memcpy).
// Record format per the reference writer (src/trim_single.cpp:390-396);
// rewrite_comment=1 emits upstream-1.33 bare '+'; n_mask rows become the
// pe -M replacement record (seq "N", quality = lowq).
void sk_assemble(const uint8_t* data, int64_t k, const int64_t* name_start,
                 const int32_t* name_len, const int64_t* seq_start,
                 const int64_t* comment_start, const int32_t* comment_len,
                 const int64_t* qual_start, const int32_t* five,
                 const int32_t* three, const uint8_t* n_mask,
                 int rewrite_comment, uint8_t lowq, const int64_t* out_offsets,
                 uint8_t* out, int n_threads) {
  AssembleCtx ctx{data,       name_start, name_len,       seq_start,
                  comment_start, comment_len, qual_start, five,
                  three,      n_mask,     rewrite_comment, lowq,
                  out_offsets, out};
  parallel_for(k, n_threads, assemble_body, &ctx);
}

// --- quality wire compression: field packing ---------------------------
//
// FASTQ quality chars span a narrow band (typically ~40 distinct values),
// so the engine can ship 6 BIT-PLANES of (q - bias) instead of 8-bit bytes: 25% fewer wire bytes, decoded
// back to integers on-device with shifts (ops/trim.py decode_planes).
// Bit extraction is one pmovmskb per 16 input bytes per plane (SSE2).

int sk_qual_minmax(const uint8_t* qual, int64_t n, uint8_t* out_min,
                   uint8_t* out_max, int n_threads);

int sk_fieldpack(const uint8_t* qual, int64_t B, int64_t L, uint8_t bias,
                 const uint8_t* levels, int n_levels, int p, uint8_t* out,
                 int n_threads);

}  // extern "C"

#if defined(__SSE2__)
#include <emmintrin.h>
#endif

namespace {

struct MinMaxCtx {
  const uint8_t* p;
  std::atomic<uint32_t> mn{255}, mx{0};
};

// min over NONZERO bytes (0 = row padding), max over all bytes
static void minmax_body(int64_t lo, int64_t hi, void* vctx) {
  MinMaxCtx* c = static_cast<MinMaxCtx*>(vctx);
  const uint8_t* p = c->p;
  uint8_t mn = 255, mx = 0;
  int64_t i = lo;
#if defined(__SSE2__)
  __m128i vmn = _mm_set1_epi8(char(255)), vmx = _mm_setzero_si128();
  const __m128i zero = _mm_setzero_si128();
  for (; i + 16 <= hi; i += 16) {
    __m128i x = _mm_loadu_si128(reinterpret_cast<const __m128i*>(p + i));
    // zeros -> 255 so padding never wins the min
    __m128i xz = _mm_or_si128(x, _mm_cmpeq_epi8(x, zero));
    vmn = _mm_min_epu8(vmn, xz);
    vmx = _mm_max_epu8(vmx, x);
  }
  alignas(16) uint8_t tmp[16];
  _mm_store_si128(reinterpret_cast<__m128i*>(tmp), vmn);
  for (int k = 0; k < 16; k++) mn = std::min(mn, tmp[k]);
  _mm_store_si128(reinterpret_cast<__m128i*>(tmp), vmx);
  for (int k = 0; k < 16; k++) mx = std::max(mx, tmp[k]);
#endif
  for (; i < hi; i++) {
    uint8_t v = p[i];
    if (v) mn = std::min(mn, v);
    mx = std::max(mx, v);
  }
  uint32_t cur = c->mn.load(std::memory_order_relaxed);
  while (mn < cur && !c->mn.compare_exchange_weak(cur, mn)) {}
  cur = c->mx.load(std::memory_order_relaxed);
  while (mx > cur && !c->mx.compare_exchange_weak(cur, mx)) {}
}

struct LevelsCtx {
  const uint8_t* p;
  std::atomic<uint64_t> seen[4];  // 256-bit presence bitmap
};

static void levels_body(int64_t lo, int64_t hi, void* vctx) {
  LevelsCtx* c = static_cast<LevelsCtx*>(vctx);
  uint64_t local[4] = {0, 0, 0, 0};
  for (int64_t i = lo; i < hi; i++) {
    uint8_t v = c->p[i];
    local[v >> 6] |= 1ull << (v & 63);
  }
  for (int k = 0; k < 4; k++) {
    if (local[k]) c->seen[k].fetch_or(local[k], std::memory_order_relaxed);
  }
}

// --- field wire: byte-aligned subfield packing -------------------------
//
// Binary decomposition of the p-bit biased value into byte-aligned
// subfields of width 4, 2, 1 (p = 6 -> 4+2, p = 3 -> 2+1, ...): SAME
// wire bytes as p bit-planes (p*L/8 per row) but the device decode is
// one lane-repeat + shift + mask per FIELD instead of per BIT — ~3x
// fewer decode passes for the common 6-bit band (ops/trim.decode_fields
// is the inverse).  Output layout per row: the fields back to back,
// widest first, each field packing 8/width values per byte LSB-first;
// the widest field carries v's LOWEST bits.
struct FieldPackCtx {
  const uint8_t* qual;
  int64_t B, L, nb;       // nb = p*L/8: output row stride
  uint8_t bias;           // band mode (n_levels == 0): v = sat(q - bias)
  const uint8_t* levels;  // rank mode: v = 1 + rank(q) over these levels
  int n_levels;
  int p;
  uint8_t* out;
};

struct FieldDef {
  int w;        // field width in bits (4, 2 or 1)
  int shift;    // v bit offset this field carries
  int64_t col;  // byte column offset in the output row
};

static int field_defs(int p, int64_t L, FieldDef* F) {
  int n = 0, sh = 0;
  int64_t col = 0;
  for (int wd : {4, 2, 1}) {
    if (p - sh >= wd) {
      F[n++] = {wd, sh, col};
      sh += wd;
      col += L * wd / 8;
    }
  }
  return n;
}

static void fieldpack_body(int64_t lo, int64_t hi, void* vctx) {
  FieldPackCtx* c = static_cast<FieldPackCtx*>(vctx);
  const int64_t L = c->L;
  FieldDef F[3];
  const int nf = field_defs(c->p, L, F);
  thread_local std::vector<uint8_t> scratch;
  if ((int64_t)scratch.size() < L + 64) scratch.resize(L + 64, 0);
  uint8_t* v = scratch.data();
  for (int64_t b = lo; b < hi; b++) {
    const uint8_t* row = c->qual + b * L;
    int64_t j = 0;
#if defined(__SSE2__)
    if (c->n_levels == 0) {
      const __m128i vbias = _mm_set1_epi8(char(c->bias));
      for (; j + 16 <= L; j += 16) {
        __m128i x =
            _mm_loadu_si128(reinterpret_cast<const __m128i*>(row + j));
        _mm_storeu_si128(reinterpret_cast<__m128i*>(v + j),
                         _mm_subs_epu8(x, vbias));
      }
    } else {
      __m128i thr[8];
      for (int k = 0; k < c->n_levels; k++)
        thr[k] = _mm_set1_epi8(char(c->levels[k]));
      for (; j + 16 <= L; j += 16) {
        __m128i x =
            _mm_loadu_si128(reinterpret_cast<const __m128i*>(row + j));
        __m128i r = _mm_setzero_si128();
        for (int k = 0; k < c->n_levels; k++) {
          __m128i ge = _mm_cmpeq_epi8(_mm_max_epu8(x, thr[k]), x);
          r = _mm_sub_epi8(r, ge);  // v = 1 + rank; padding NULs -> 0
        }
        _mm_storeu_si128(reinterpret_cast<__m128i*>(v + j), r);
      }
    }
#endif
    for (; j < L; j++) {
      uint8_t q = row[j];
      if (c->n_levels == 0) {
        v[j] = q > c->bias ? uint8_t(q - c->bias) : uint8_t(0);
      } else {
        uint8_t r = 0;
        for (int k = 0; k < c->n_levels; k++) r += (q >= c->levels[k]);
        v[j] = r;
      }
    }
    for (int f = 0; f < nf; f++) {
      const int w = F[f].w, sh = F[f].shift;
      const uint8_t mask = uint8_t((1 << w) - 1);
      uint8_t* o = c->out + b * c->nb + F[f].col;
      int64_t i = 0, oi = 0;
#if defined(__SSE2__)
      const __m128i fmask = _mm_set1_epi8(char(mask));
      const __m128i lob = _mm_set1_epi16(0x00FF);
      auto fld = [&](int64_t at) {
        __m128i x =
            _mm_loadu_si128(reinterpret_cast<const __m128i*>(v + at));
        if (sh) x = _mm_srli_epi16(x, sh);
        return _mm_and_si128(x, fmask);
      };
      if (w == 4) {
        for (; i + 32 <= L; i += 32, oi += 16) {
          __m128i a = fld(i), bx = fld(i + 16);
          // u16 lane = f0 + 256*f1 -> low byte f0 | f1<<4
          a = _mm_and_si128(_mm_or_si128(a, _mm_srli_epi16(a, 4)), lob);
          bx = _mm_and_si128(_mm_or_si128(bx, _mm_srli_epi16(bx, 4)), lob);
          _mm_storeu_si128(reinterpret_cast<__m128i*>(o + oi),
                           _mm_packus_epi16(a, bx));
        }
      } else if (w == 2) {
        for (; i + 64 <= L; i += 64, oi += 16) {
          __m128i t[4];
          for (int k = 0; k < 4; k++) {
            __m128i a = fld(i + 16 * k);
            // pairs: f0 | f1<<2 in each u16's low byte
            t[k] = _mm_and_si128(_mm_or_si128(a, _mm_srli_epi16(a, 6)), lob);
          }
          __m128i ab = _mm_packus_epi16(t[0], t[1]);
          __m128i cd = _mm_packus_epi16(t[2], t[3]);
          // pairs of 4-bit halves: g0 | g1<<4
          ab = _mm_and_si128(_mm_or_si128(ab, _mm_srli_epi16(ab, 4)), lob);
          cd = _mm_and_si128(_mm_or_si128(cd, _mm_srli_epi16(cd, 4)), lob);
          _mm_storeu_si128(reinterpret_cast<__m128i*>(o + oi),
                           _mm_packus_epi16(ab, cd));
        }
      } else {  // w == 1
        const __m128i hibit = _mm_set1_epi8(char(0x80));
        for (; i + 16 <= L; i += 16, oi += 2) {
          __m128i a = fld(i);
          __m128i t = _mm_and_si128(_mm_slli_epi16(a, 7), hibit);
          int m = _mm_movemask_epi8(t);
          o[oi] = uint8_t(m & 0xff);
          o[oi + 1] = uint8_t(m >> 8);
        }
      }
#endif
      // scalar tail (L is an 8-multiple; covers L % 32/64 remainders)
      const int per = 8 / w;
      for (; i < L; i += per, oi++) {
        uint8_t acc = 0;
        for (int k = 0; k < per && i + k < L; k++) {
          acc |= uint8_t(((v[i + k] >> sh) & mask) << (k * w));
        }
        o[oi] = acc;
      }
    }
  }
}

}  // namespace

extern "C" {

// Distinct byte values of a qual matrix (parallel 256-bit presence
// bitmap).  Writes ascending NONZERO values into out_levels (cap 256)
// and returns the count (zero bytes are row padding and excluded).
// One pass replaces the min/max scan AND enables the rank wire: when a
// chunk has <= 7 distinct quality levels (binned Illumina), chars ship
// as dictionary ranks in ceil(log2(levels+1)) wire bits instead of the
// band width's 6.
int sk_qual_levels(const uint8_t* qual, int64_t n, uint8_t* out_levels,
                   int n_threads) {
  LevelsCtx ctx;
  ctx.p = qual;
  for (int k = 0; k < 4; k++) ctx.seen[k].store(0);
  parallel_for(n, n_threads, levels_body, &ctx);
  int cnt = 0;
  for (int v = 1; v < 256; v++) {
    if (ctx.seen[v >> 6].load() >> (v & 63) & 1) {
      out_levels[cnt++] = uint8_t(v);
    }
  }
  return cnt;
}

// min (over nonzero bytes) / max (over all) of a packed qual matrix.
// Returns 0; *out_min = 255 if every byte is zero.
int sk_qual_minmax(const uint8_t* qual, int64_t n, uint8_t* out_min,
                   uint8_t* out_max, int n_threads) {
  MinMaxCtx ctx;
  ctx.p = qual;
  parallel_for(n, n_threads, minmax_body, &ctx);
  *out_min = uint8_t(ctx.mn.load());
  *out_max = uint8_t(ctx.mx.load());
  return 0;
}

// Fused keep-filter + size + prefix + emit for the se fast path: one
// call replaces flatnonzero + six index gathers + out-size computation
// + cumsum + sk_assemble.  Reads the parse line index (starts4/lens4)
// directly — record r's lines are starts4[4r..4r+3] / lens4[..] — and
// writes kept records (three[r] >= 0) back to back into `out` in input
// order.  rewrite_comment=1 emits the upstream-1.33 bare '+'.  Returns
// total bytes written; *out_kept = kept record count.  Caller sizes
// `out` with the chunk's source byte count (output never exceeds input).
int64_t sk_plan_assemble(const uint8_t* data, const int64_t* starts4,
                         const int32_t* lens4, const int32_t* five,
                         const int32_t* three, int64_t n,
                         int rewrite_comment, uint8_t* out,
                         int64_t* out_kept, int n_threads) {
  int nt = std::max(1, n_threads);
  if (n < 4096) nt = 1;
  std::vector<int64_t> t_bytes(nt, 0), t_kept(nt, 0);
  int64_t chunk = (n + nt - 1) / nt;
  run_tasks(nt, [&](int ti) {
    int64_t lo = ti * chunk, hi = std::min(n, lo + chunk);
    int64_t bytes = 0, kept = 0;
    for (int64_t r = lo; r < hi; r++) {
      if (three[r] < 0) continue;
      int64_t cut = three[r] - five[r];
      int64_t com = rewrite_comment ? 1 : lens4[4 * r + 2];
      bytes += lens4[4 * r] + 2 * cut + com + 4;
      kept++;
    }
    t_bytes[ti] = bytes;
    t_kept[ti] = kept;
  });
  std::vector<int64_t> base(nt + 1, 0);
  int64_t kept_total = 0;
  for (int ti = 0; ti < nt; ti++) {
    base[ti + 1] = base[ti] + t_bytes[ti];
    kept_total += t_kept[ti];
  }
  run_tasks(nt, [&](int ti) {
    int64_t lo = ti * chunk, hi = std::min(n, lo + chunk);
    uint8_t* o = out + base[ti];
    for (int64_t r = lo; r < hi; r++) {
      if (three[r] < 0) continue;
      int32_t cut = three[r] - five[r];
      int32_t nl = lens4[4 * r];
      memcpy(o, data + starts4[4 * r], nl);
      o += nl;
      *o++ = '\n';
      memcpy(o, data + starts4[4 * r + 1] + five[r], cut);
      o += cut;
      *o++ = '\n';
      if (rewrite_comment) {
        *o++ = '+';
      } else {
        int32_t cl = lens4[4 * r + 2];
        memcpy(o, data + starts4[4 * r + 2], cl);
        o += cl;
      }
      *o++ = '\n';
      memcpy(o, data + starts4[4 * r + 3] + five[r], cut);
      o += cut;
      *o++ = '\n';
    }
  });
  *out_kept = kept_total;
  return base[nt];
}

// Field-wire pack (see fieldpack_body): v = sat(q - bias), or the rank
// code 1 + rank(q in levels) when n_levels > 0, split into byte-aligned
// 4/2/1-bit subfields; out is [B, p*L/8].  L must be a multiple of 8.
int sk_fieldpack(const uint8_t* qual, int64_t B, int64_t L, uint8_t bias,
                 const uint8_t* levels, int n_levels, int p, uint8_t* out,
                 int n_threads) {
  if (L % 8 || p < 1 || p > 7 || n_levels > 8) return 1;
  FieldPackCtx ctx{qual, B, L, p * L / 8, bias, levels, n_levels, p, out};
  parallel_for(B, n_threads, fieldpack_body, &ctx);
  return 0;
}

}  // extern "C"

#include <zlib.h>
#include <dlfcn.h>

namespace {

// libdeflate (dlopen'd at first use, zlib fallback): ~2-3x faster
// per-core inflate/deflate than zlib for whole-buffer (single-shot)
// work, which is exactly the BGZF block shape.  The reference is
// zlib-only (/root/reference/src/GZReader.cpp:13,77); we keep zlib for
// the serial streaming paths and use libdeflate for the block-parallel
// BGZF codec below.
struct LibDeflate {
  void* (*alloc_decompressor)();
  // returns 0 (LIBDEFLATE_SUCCESS) on success
  int (*gzip_decompress)(void*, const void*, size_t, void*, size_t, size_t*);
  void (*free_decompressor)(void*);
  void* (*alloc_compressor)(int);
  size_t (*deflate_compress)(void*, const void*, size_t, void*, size_t);
  void (*free_compressor)(void*);
  uint32_t (*crc32)(uint32_t, const void*, size_t);
  bool ok = false;
};

const LibDeflate& libdeflate() {
  static const LibDeflate ld = [] {
    LibDeflate d{};
    void* h = dlopen("libdeflate.so.0", RTLD_NOW | RTLD_LOCAL);
    if (!h) h = dlopen("libdeflate.so", RTLD_NOW | RTLD_LOCAL);
    if (!h) return d;
    auto sym = [h](const char* name) { return dlsym(h, name); };
    d.alloc_decompressor = reinterpret_cast<void* (*)()>(
        sym("libdeflate_alloc_decompressor"));
    d.gzip_decompress =
        reinterpret_cast<int (*)(void*, const void*, size_t, void*, size_t,
                                 size_t*)>(sym("libdeflate_gzip_decompress"));
    d.free_decompressor = reinterpret_cast<void (*)(void*)>(
        sym("libdeflate_free_decompressor"));
    d.alloc_compressor = reinterpret_cast<void* (*)(int)>(
        sym("libdeflate_alloc_compressor"));
    d.deflate_compress =
        reinterpret_cast<size_t (*)(void*, const void*, size_t, void*,
                                    size_t)>(sym("libdeflate_deflate_compress"));
    d.free_compressor = reinterpret_cast<void (*)(void*)>(
        sym("libdeflate_free_compressor"));
    d.crc32 = reinterpret_cast<uint32_t (*)(uint32_t, const void*, size_t)>(
        sym("libdeflate_crc32"));
    d.ok = d.alloc_decompressor && d.gzip_decompress && d.free_decompressor &&
           d.alloc_compressor && d.deflate_compress && d.free_compressor &&
           d.crc32;
    return d;
  }();
  return ld;
}

}  // namespace

namespace {

// BGZF (blocked gzip, SAM spec §4.1): each <=64 KiB block is a complete
// gzip member whose FEXTRA 'BC' subfield carries the compressed block
// size, so block boundaries are found by a header walk with NO
// decompression — which is what makes both directions parallel.
constexpr int64_t kBgzfInBlock = 48 * 1024;  // uncompressed bytes per block
constexpr int64_t kBgzfStride = kBgzfInBlock + 4096;  // worst-case deflate
constexpr uint8_t kBgzfEof[28] = {
    0x1f, 0x8b, 0x08, 0x04, 0, 0, 0, 0, 0, 0xff, 0x06, 0x00,
    0x42, 0x43, 0x02, 0x00, 0x1b, 0x00, 0x03, 0x00,
    0, 0, 0, 0, 0, 0, 0, 0};

int64_t bgzf_block_size(const uint8_t* p, int64_t avail) {
  // returns the compressed block size at p, or -1 if not a BGZF header
  if (avail < 18 || p[0] != 0x1f || p[1] != 0x8b || p[2] != 8 ||
      !(p[3] & 4)) {
    return -1;
  }
  int64_t xlen = p[10] | (p[11] << 8);
  if (12 + xlen > avail) return -1;
  int64_t e = 12;
  while (e + 4 <= 12 + xlen) {
    int64_t slen = p[e + 2] | (p[e + 3] << 8);
    if (p[e] == 'B' && p[e + 1] == 'C' && slen == 2) {
      int64_t bsize = (p[e + 4] | (p[e + 5] << 8)) + 1;
      return (bsize >= 18 && bsize <= avail) ? bsize : -1;
    }
    e += 4 + slen;
  }
  return -1;
}

}  // namespace

extern "C" {

// 1 when BGZF blocks inflate/deflate through libdeflate, 0 for zlib.
int sk_inflate_backend() { return libdeflate().ok ? 1 : 0; }

// Header-walk a BGZF byte buffer.  Writes per-block (compressed offset,
// compressed size, uncompressed size) and returns the block count; -1 if
// the buffer is not BGZF-structured end to end (caller falls back to the
// serial zlib stream), -2 if max_blocks is too small.
int64_t sk_bgzf_scan(const uint8_t* data, int64_t n, int64_t* offs,
                     int64_t* csizes, int64_t* usizes, int64_t max_blocks) {
  int64_t off = 0, k = 0;
  while (off < n) {
    int64_t bsize = bgzf_block_size(data + off, n - off);
    if (bsize < 0) return -1;
    if (k >= max_blocks) return -2;
    offs[k] = off;
    csizes[k] = bsize;
    const uint8_t* tail = data + off + bsize - 4;
    usizes[k] = tail[0] | (tail[1] << 8) | (tail[2] << 16) |
                (static_cast<int64_t>(tail[3]) << 24);
    k++;
    off += bsize;
  }
  return k;
}

// Parallel-inflate BGZF blocks [first, first+count) into `out`, laid out
// back to back (caller passes cumulative uncompressed offsets in uoffs).
// Returns 0, or 1 + the index of the first corrupt block.
int64_t sk_bgzf_inflate(const uint8_t* data, const int64_t* offs,
                        const int64_t* csizes, const int64_t* uoffs,
                        const int64_t* usizes, int64_t count, uint8_t* out,
                        int n_threads) {
  std::atomic<int64_t> bad(0);
  int nt = std::max(1, n_threads);
  std::atomic<int64_t> cursor(0);
  const LibDeflate& ld = libdeflate();
  run_tasks(nt, [&](int) {
    void* dec = ld.ok ? ld.alloc_decompressor() : nullptr;
    z_stream zs;
    for (;;) {
      int64_t i = cursor.fetch_add(1);
      if (i >= count || bad.load(std::memory_order_relaxed)) break;
      if (dec) {
        // nullptr actual-size => must decompress to exactly usizes[i]
        int rc = ld.gzip_decompress(dec, data + offs[i], size_t(csizes[i]),
                                    out + uoffs[i], size_t(usizes[i]),
                                    nullptr);
        if (rc != 0) bad.store(i + 1);
        continue;
      }
      memset(&zs, 0, sizeof(zs));
      if (inflateInit2(&zs, 15 + 16) != Z_OK) {
        bad.store(i + 1);
        break;
      }
      zs.next_in = const_cast<uint8_t*>(data + offs[i]);
      zs.avail_in = static_cast<uInt>(csizes[i]);
      zs.next_out = out + uoffs[i];
      zs.avail_out = static_cast<uInt>(usizes[i]);
      int rc = inflate(&zs, Z_FINISH);
      if (rc != Z_STREAM_END || zs.total_out != (uLong)usizes[i]) {
        bad.store(i + 1);
      }
      inflateEnd(&zs);
    }
    if (dec) ld.free_decompressor(dec);
  });
  return bad.load();
}

// Parallel BGZF compression of `n` bytes at `level`; writes a compacted
// block stream (plus the BGZF EOF marker when `final_eof`) into `out`
// (sized >= ceil(n/48K)*stride + 28) and returns the compressed size.
int64_t sk_bgzf_compress(const uint8_t* data, int64_t n, int level,
                         int final_eof, uint8_t* out, int n_threads) {
  int64_t n_blocks = n ? (n + kBgzfInBlock - 1) / kBgzfInBlock : 0;
  std::vector<int64_t> bsize(n_blocks, 0);
  std::atomic<int64_t> cursor(0);
  std::atomic<int> failed(0);
  int nt = std::max(1, n_threads);
  const LibDeflate& ld = libdeflate();
  run_tasks(nt, [&](int) {
    // zlib levels 0-9 map onto libdeflate's 1-12 scale directly at the
    // low end we use (default 4); clamp for safety.
    void* comp = ld.ok ? ld.alloc_compressor(std::max(1, std::min(level, 12)))
                       : nullptr;
    z_stream zs;
    for (;;) {
      int64_t i = cursor.fetch_add(1);
      if (i >= n_blocks || failed.load(std::memory_order_relaxed)) break;
      const uint8_t* in = data + i * kBgzfInBlock;
      uInt in_len = static_cast<uInt>(
          std::min<int64_t>(kBgzfInBlock, n - i * kBgzfInBlock));
      uint8_t* o = out + i * kBgzfStride;
      // gzip header with BC subfield (BSIZE patched after deflate)
      memcpy(o,
             "\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff\x06\x00\x42\x43"
             "\x02\x00\x00\x00",
             18);
      int64_t clen;
      if (comp) {
        clen = int64_t(ld.deflate_compress(comp, in, size_t(in_len), o + 18,
                                           size_t(kBgzfStride - 26)));
        if (clen == 0) {  // 0 = would not fit (can't happen at our stride)
          failed.store(1);
          break;
        }
      } else {
        memset(&zs, 0, sizeof(zs));
        if (deflateInit2(&zs, level, Z_DEFLATED, -15, 8,
                         Z_DEFAULT_STRATEGY) != Z_OK) {
          failed.store(1);
          break;
        }
        zs.next_in = const_cast<uint8_t*>(in);
        zs.avail_in = in_len;
        zs.next_out = o + 18;
        zs.avail_out = static_cast<uInt>(kBgzfStride - 26);
        int rc = deflate(&zs, Z_FINISH);
        clen = zs.total_out;
        deflateEnd(&zs);
        if (rc != Z_STREAM_END) {
          failed.store(1);
          break;
        }
      }
      int64_t total = 18 + clen + 8;
      o[16] = static_cast<uint8_t>((total - 1) & 0xff);
      o[17] = static_cast<uint8_t>(((total - 1) >> 8) & 0xff);
      uLong crc = comp ? uLong(ld.crc32(0, in, in_len)) : crc32(0, in, in_len);
      uint8_t* tail = o + 18 + clen;
      tail[0] = crc & 0xff;
      tail[1] = (crc >> 8) & 0xff;
      tail[2] = (crc >> 16) & 0xff;
      tail[3] = (crc >> 24) & 0xff;
      tail[4] = in_len & 0xff;
      tail[5] = (in_len >> 8) & 0xff;
      tail[6] = (in_len >> 16) & 0xff;
      tail[7] = (in_len >> 24) & 0xff;
      bsize[i] = total;
    }
    if (comp) ld.free_compressor(comp);
  });
  if (failed.load()) return -1;
  // compact the strided blocks into one contiguous stream
  int64_t w = 0;
  for (int64_t i = 0; i < n_blocks; i++) {
    if (w != i * kBgzfStride) memmove(out + w, out + i * kBgzfStride, bsize[i]);
    w += bsize[i];
  }
  if (final_eof) {
    memcpy(out + w, kBgzfEof, sizeof(kBgzfEof));
    w += sizeof(kBgzfEof);
  }
  return w;
}

}  // extern "C"
