// ptpu_capture — LD_PRELOAD execution-capture frontend (SURVEY.md §2 #1).
//
// The reference's Pin tool instruments every instruction and intercepts
// pthread routines so target synchronization is modeled rather than
// host-timed (SURVEY.md §3.2/3.5). This shim is the same idea at
// LD_PRELOAD granularity: it interposes pthread_create/mutex/barrier,
// counts REAL retired instructions between events with perf_event_open
// (PERF_COUNT_HW_INSTRUCTIONS per thread; falls back to a TSC-based
// estimate, then to zero, when perf is unavailable in the container), and
// optionally captures memcpy/memset as line-granular LD/ST traffic. On
// process exit it writes a PTPU v4 binary trace (trace/format.py layout,
// line_addressed flag) ready for `python -m primesim_tpu_torch run --trace`.
//
// Environment:
//   PTPU_TRACE_OUT      output path (default ptpu_capture.ptpu)
//   PTPU_MAX_CORES      thread slots (default 256)
//   PTPU_MAX_EVENTS     per-thread event cap (default 1<<20)
//   PTPU_CAPTURE_MEMOPS 1 = interpose memcpy/memset as LD/ST (default 1)
//   PTPU_LINE           cache-line bytes for memop expansion (default 64)
//   PTPU_MEMOP_MAX_LINES max lines emitted per memcpy/memset (default 64)
//   PTPU_RING_OUT       ONLINE MODE: mmap'd shared-memory ring file the
//                       host simulator drains WHILE this process runs
//                       (SURVEY.md §2 #9's shared-memory queue fast path;
//                       replaces the end-of-run trace file — events go
//                       straight to per-thread SPSC rings)
//   PTPU_RING_RECORDS   per-thread ring capacity in 16-byte records
//                       (default 1<<16)
//   PTPU_RING_TIMEOUT_MS max wait on a full ring before dropping events
//                       (default 30000; a vanished host must not hang
//                       the target forever)
//
// Addresses are emitted LINE-granular (PTPU v4 line_addressed flag): the
// 31-bit addr field holds `byte_address / PTPU_LINE`, widening coverage
// 64x over byte addressing (2^31 lines = 128 GiB at 64-byte lines; line
// indices beyond that still alias under the 31-bit mask — a 2x32-bit
// record is the future fully-un-aliased path). The capture line size is
// recorded in flags bits 8-15 so engines reject mismatched configs.
// Mutex addresses identify the lock by line; barrier ids are dense
// registration indices with the participant count from
// pthread_barrier_init.
//
// Build: g++ -O2 -shared -fPIC -o libptpu_capture.so ptpu_capture.cpp -ldl -lpthread

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

#include <dlfcn.h>
#include <fcntl.h>
#include <linux/perf_event.h>
#include <pthread.h>
#include <sched.h>
#include <sys/ioctl.h>
#include <sys/mman.h>
#include <sys/syscall.h>
#include <time.h>
#include <unistd.h>

namespace {

// ---- event model (trace/format.py) ----------------------------------------
constexpr int32_t EV_INS = 0, EV_LD = 1, EV_ST = 2, EV_END = 3;
constexpr int32_t EV_LOCK = 4, EV_UNLOCK = 5, EV_BARRIER = 6;
constexpr uint32_t PTPU_MAGIC = 0x50545055u;
constexpr uint32_t PTPU_VERSION = 4;
constexpr uint32_t FLAG_LINE_ADDRESSED = 1;  // v4: addr = line index
constexpr int32_t ADDR_MASK = 0x7fffffff;
// Per-event instruction-batch cap: keeps the engine's per-chunk counter
// accumulators far from their 2^30 carry bound at default chunk sizes.
constexpr int64_t MAX_BATCH = 1 << 20;

struct Event {
  int32_t type, arg, addr, pre;
};

// ---- online shared-memory ring (PTPU_RING_OUT) ----------------------------
// One SPSC ring per thread slot inside one mmap'd file the host simulator
// maps concurrently. The thread is the only writer of `widx` and the data
// it guards (release-published); the host is the only writer of `ridx`.
// File layout (all little-endian):
//   [0..64)                      RingHeader
//   [64 .. 64 + n*64)            RingCtl per thread slot (cacheline each)
//   [data0 ...]                  n rings of `records` 16-byte events
constexpr uint32_t RING_MAGIC = 0x50525247u;  // 'PRRG'
constexpr uint32_t RING_VERSION = 1;
constexpr uint32_t RSTATE_UNUSED = 0, RSTATE_ACTIVE = 1, RSTATE_DONE = 2;

struct RingHeader {
  uint32_t magic, version;
  uint32_t max_cores, records;
  uint32_t line, flags;
  // producer_done: set once by the exit hook after every row is flushed —
  // the host treats (producer_done && state != ACTIVE && drained) as EOF
  std::atomic<uint32_t> producer_done;
  uint32_t _pad[9];
};
static_assert(sizeof(RingHeader) == 64, "ring header layout");

struct RingCtl {
  std::atomic<uint64_t> widx;  // thread-owned
  std::atomic<uint64_t> ridx;  // host-owned
  std::atomic<uint32_t> state;
  uint32_t _pad0;
  std::atomic<uint64_t> dropped;
  uint32_t _pad[8];
};
static_assert(sizeof(RingCtl) == 64, "ring ctl layout");

uint8_t* g_ring_base = nullptr;  // mmap'd file; null = offline capture
RingHeader* g_ring_hdr = nullptr;
RingCtl* g_ring_ctl = nullptr;
Event* g_ring_data = nullptr;
uint32_t g_ring_records = 1 << 16;
int64_t g_ring_timeout_ms = 30000;

struct ThreadRec {
  Event* ev = nullptr;
  int64_t n = 0;
  int64_t cap = 0;
  int64_t dropped = 0;
  int64_t n_mem = 0;   // captured LD/ST line events (coverage stat)
  int64_t n_sync = 0;  // captured lock/unlock/barrier events
  int64_t n_ins = 0;   // instructions attributed via perf/TSC
  int perf_fd = -1;
  uint64_t last_count = 0;  // instructions (or TSC) at last event
  bool tsc_fallback = false;
  bool active = false;
  // guards ev/n/cap between the owning thread's emits and write_trace()
  // flushing at process exit while unjoined threads still run (a real
  // program may exit() without joining workers)
  std::atomic_flag mu = ATOMIC_FLAG_INIT;
  void lock() {
    while (mu.test_and_set(std::memory_order_acquire)) {
    }
  }
  void unlock() { mu.clear(std::memory_order_release); }
};

int g_max_cores = 256;
int64_t g_max_events = 1 << 20;
bool g_capture_memops = true;
int g_line = 64;
int g_memop_max_lines = 64;
ThreadRec* g_threads = nullptr;
std::atomic<int> g_next_core{0};
std::atomic<int> g_next_barrier_id{0};
// set at trace-write time; emits from unjoined threads then drop, so the
// recorded row lengths stay consistent with the rows written
std::atomic<bool> g_shutdown{false};
pthread_mutex_t g_reg_mu = PTHREAD_MUTEX_INITIALIZER;

// barrier registry: pthread_barrier_t* -> (dense id, participant count)
struct BarrierRec {
  void* key;
  int32_t id;
  int32_t count;
};
BarrierRec* g_barriers = nullptr;
int g_n_barriers = 0, g_barriers_cap = 0;

thread_local int t_core = -1;
thread_local bool t_in_shim = false;  // recursion guard (memcpy in shim)

// real libc/libpthread entry points
int (*real_pthread_create)(pthread_t*, const pthread_attr_t*,
                           void* (*)(void*), void*) = nullptr;
int (*real_mutex_lock)(pthread_mutex_t*) = nullptr;
int (*real_mutex_trylock)(pthread_mutex_t*) = nullptr;
int (*real_mutex_unlock)(pthread_mutex_t*) = nullptr;
int (*real_barrier_init)(pthread_barrier_t*, const pthread_barrierattr_t*,
                         unsigned) = nullptr;
int (*real_barrier_wait)(pthread_barrier_t*) = nullptr;
void* (*real_memcpy)(void*, const void*, size_t) = nullptr;
void* (*real_memset)(void*, int, size_t) = nullptr;

template <typename T>
void resolve(T& fn, const char* name) {
  fn = reinterpret_cast<T>(dlsym(RTLD_NEXT, name));
}

// ---- retired-instruction counting -----------------------------------------

uint64_t rdtsc_now() {
#if defined(__x86_64__)
  uint32_t lo, hi;
  __asm__ __volatile__("rdtsc" : "=a"(lo), "=d"(hi));
  return (uint64_t(hi) << 32) | lo;
#else
  return 0;  // no estimate on non-x86; INS batches become 0
#endif
}

int perf_open_self() {
  struct perf_event_attr pe;
  memset(&pe, 0, sizeof(pe));
  pe.type = PERF_TYPE_HARDWARE;
  pe.size = sizeof(pe);
  pe.config = PERF_COUNT_HW_INSTRUCTIONS;
  pe.disabled = 0;
  pe.exclude_kernel = 1;
  pe.exclude_hv = 1;
  return (int)syscall(__NR_perf_event_open, &pe, 0, -1, -1, 0);
}

uint64_t counter_read(ThreadRec& tr) {
  if (!tr.tsc_fallback) {
    uint64_t v = 0;
    if (tr.perf_fd >= 0 && read(tr.perf_fd, &v, sizeof(v)) == sizeof(v))
      return v;
    // permanent source switch — mixing perf values with TSC values would
    // fabricate a delta of ~TSC-since-boot; re-anchor on the new source
    tr.tsc_fallback = true;
    tr.last_count = rdtsc_now();
  }
  return rdtsc_now();  // (0 on non-x86: INS batches become 0)
}

// ---- per-thread event emission --------------------------------------------

void thread_register() {
  if (t_core >= 0) return;
  int c = g_next_core.fetch_add(1);
  if (c >= g_max_cores) {
    t_core = -2;  // overflow: capture nothing for this thread
    return;
  }
  t_core = c;
  ThreadRec& tr = g_threads[c];
  // Registration writes happen under tr.mu: write_trace()'s locked flush
  // pass can run concurrently when the process exits while a worker is
  // mid-registration, and without the lock `active = true` could become
  // visible before ev/cap under relaxed ordering (unsynchronized race).
  // t_in_shim guards the whole section: malloc/read below may call the
  // interposed memcpy/memset, whose emit would spin on the held tr.mu.
  bool saved_in_shim = t_in_shim;
  t_in_shim = true;
  tr.lock();
  if (!g_shutdown.load(std::memory_order_relaxed)) {
    if (!g_ring_base) {
      tr.ev = (Event*)malloc(sizeof(Event) * 4096);
      tr.cap = 4096;
    }
    tr.n = 0;
    tr.perf_fd = perf_open_self();
    tr.tsc_fallback = tr.perf_fd < 0;
    tr.last_count = counter_read(tr);
    tr.active = true;
    if (g_ring_base)
      g_ring_ctl[c].state.store(RSTATE_ACTIVE, std::memory_order_release);
  } else {
    t_core = -2;  // trace already written: capture nothing for this thread
  }
  tr.unlock();
  t_in_shim = saved_in_shim;
}

// instructions retired since the last event; TSC fallback scales cycles
// by an assumed IPC of 1 (documented estimate). Deltas are clamped at
// 16*MAX_BATCH (16M instructions between two events): anything larger is
// a counter glitch or host idle time, not workload, and the clamp bounds
// the INS-split fan-out per event.
int64_t ins_delta(ThreadRec& tr) {
  uint64_t now = counter_read(tr);
  int64_t d = (int64_t)(now - tr.last_count);
  tr.last_count = now;
  if (d < 0) return 0;
  return d > 16 * MAX_BATCH ? 16 * MAX_BATCH : d;
}

void ring_push(int core, const Event& e) {
  RingCtl& rc = g_ring_ctl[core];
  uint64_t w = rc.widx.load(std::memory_order_relaxed);
  if (w - rc.ridx.load(std::memory_order_acquire) >= g_ring_records) {
    // ring full: the host is behind (or gone). Briefly yield-spin, then
    // drop — a vanished consumer must not wedge the target program.
    struct timespec t0, t1;
    clock_gettime(CLOCK_MONOTONIC, &t0);
    for (;;) {
      sched_yield();
      if (w - rc.ridx.load(std::memory_order_acquire) < g_ring_records)
        break;
      clock_gettime(CLOCK_MONOTONIC, &t1);
      int64_t ms = (t1.tv_sec - t0.tv_sec) * 1000 +
                   (t1.tv_nsec - t0.tv_nsec) / 1000000;
      if (ms > g_ring_timeout_ms) {
        rc.dropped.fetch_add(1, std::memory_order_relaxed);
        return;
      }
    }
  }
  g_ring_data[(uint64_t)core * g_ring_records + (w % g_ring_records)] = e;
  rc.widx.store(w + 1, std::memory_order_release);  // publish after data
}

void push_raw(ThreadRec& tr, int32_t type, int32_t arg, int32_t addr,
              int32_t pre) {
  if (g_ring_base) {
    // online mode: events go straight to this thread's SPSC ring; the
    // host simulator consumes them while the program runs
    ring_push((int)(&tr - g_threads), Event{type, arg, addr, pre});
    tr.n++;  // row length still tracked for the exit summary
    return;
  }
  if (tr.n >= g_max_events) {
    tr.dropped++;
    return;
  }
  if (tr.n == tr.cap) {
    int64_t nc = tr.cap * 2;
    Event* ne = (Event*)realloc(tr.ev, sizeof(Event) * nc);
    if (!ne) {
      tr.dropped++;
      return;
    }
    tr.ev = ne;
    tr.cap = nc;
  }
  tr.ev[tr.n++] = Event{type, arg, addr, pre};
}

// split an oversized pending batch into explicit INS events, returning
// the <= MAX_BATCH remainder to fold into the next event's `pre`
int64_t split_batch(ThreadRec& tr, int64_t pre) {
  while (pre > MAX_BATCH) {
    push_raw(tr, EV_INS, (int32_t)MAX_BATCH, 0, 0);
    pre -= MAX_BATCH;
  }
  return pre;
}

// flush the whole pending batch as explicit INS events (thread retiring
// or final trace write — no follow-on event to fold into)
void flush_pending(ThreadRec& tr) {
  int64_t pre = split_batch(tr, ins_delta(tr));
  if (pre > 0) push_raw(tr, EV_INS, (int32_t)pre, 0, 0);
}

// emit an event, folding the pending instruction batch into `pre`
// (PriME's per-BBL batching folded to event boundaries, SURVEY.md §3.2)
void emit(int32_t type, int32_t arg, int32_t addr) {
  if (t_core < 0 || g_shutdown.load(std::memory_order_relaxed)) return;
  ThreadRec& tr = g_threads[t_core];
  tr.lock();
  // re-check under the lock: write_trace sets g_shutdown BEFORE taking
  // rec locks, so any emit that wins the lock after the flush pass sees
  // the flag and drops, keeping row lengths frozen
  if (!g_shutdown.load(std::memory_order_relaxed)) {
    int64_t pre = split_batch(tr, ins_delta(tr));
    push_raw(tr, type, arg, addr, (int32_t)pre);
    tr.n_ins += pre;
    if (type == EV_LD || type == EV_ST)
      tr.n_mem++;
    else if (type != EV_INS)
      tr.n_sync++;
    // exclude our own bookkeeping from the next batch
    tr.last_count = counter_read(tr);
  }
  tr.unlock();
}

void emit_memops(int32_t type, const void* p, size_t len) {
  if (t_core < 0 || len == 0) return;
  uintptr_t a0 = (uintptr_t)p & ~(uintptr_t)(g_line - 1);
  uintptr_t a1 = ((uintptr_t)p + len - 1) & ~(uintptr_t)(g_line - 1);
  int64_t lines = (int64_t)((a1 - a0) / g_line) + 1;
  if (lines > g_memop_max_lines) lines = g_memop_max_lines;
  for (int64_t i = 0; i < lines; i++) {
    int32_t addr = (int32_t)((((a0 + i * g_line)) / (uintptr_t)g_line) & ADDR_MASK);
    emit(type, g_line, addr);
  }
}

// ---- barrier registry ------------------------------------------------------

void barrier_register(void* key, unsigned count) {
  if (!real_mutex_lock) resolve(real_mutex_lock, "pthread_mutex_lock");
  if (!real_mutex_unlock) resolve(real_mutex_unlock, "pthread_mutex_unlock");
  real_mutex_lock(&g_reg_mu);
  if (g_n_barriers == g_barriers_cap) {
    g_barriers_cap = g_barriers_cap ? g_barriers_cap * 2 : 64;
    g_barriers =
        (BarrierRec*)realloc(g_barriers, sizeof(BarrierRec) * g_barriers_cap);
  }
  g_barriers[g_n_barriers++] =
      BarrierRec{key, g_next_barrier_id.fetch_add(1), (int32_t)count};
  real_mutex_unlock(&g_reg_mu);
}

BarrierRec barrier_lookup(void* key) {
  if (!real_mutex_lock) resolve(real_mutex_lock, "pthread_mutex_lock");
  if (!real_mutex_unlock) resolve(real_mutex_unlock, "pthread_mutex_unlock");
  real_mutex_lock(&g_reg_mu);
  BarrierRec out{key, -1, 0};
  for (int i = g_n_barriers - 1; i >= 0; i--) {  // latest init wins
    if (g_barriers[i].key == key) {
      out = g_barriers[i];
      break;
    }
  }
  real_mutex_unlock(&g_reg_mu);
  return out;
}

// ---- trace writer ----------------------------------------------------------

void write_trace() {
  const char* path = getenv("PTPU_TRACE_OUT");
  if (!path || !*path) path = "ptpu_capture.ptpu";
  int n_cores = g_next_core.load();
  if (n_cores > g_max_cores) n_cores = g_max_cores;
  if (n_cores == 0) return;

  if (g_ring_base) {
    // online mode: flush trailing batches into the rings, mark every row
    // finished, and publish producer_done — the host drains the rest
    g_shutdown.store(true, std::memory_order_seq_cst);
    int64_t total_dropped = 0;
    for (int c = 0; c < n_cores; c++) {
      ThreadRec& tr = g_threads[c];
      tr.lock();
      if (tr.active) flush_pending(tr);
      g_ring_ctl[c].state.store(RSTATE_DONE, std::memory_order_release);
      total_dropped +=
          (int64_t)g_ring_ctl[c].dropped.load(std::memory_order_relaxed);
      tr.unlock();
    }
    g_ring_hdr->producer_done.store(1, std::memory_order_release);
    fprintf(stderr, "ptpu_capture: ring done (%d threads%s)\n", n_cores,
            total_dropped ? ", EVENTS DROPPED on full ring" : "");
    return;
  }

  g_shutdown.store(true, std::memory_order_seq_cst);
  int64_t max_len = 1;
  int64_t total_dropped = 0;
  for (int c = 0; c < n_cores; c++) {
    // flush the trailing instruction batch of still-registered threads
    // (unjoined threads' emits drop once g_shutdown is visible, so after
    // this locked pass every row length is frozen)
    ThreadRec& tr = g_threads[c];
    tr.lock();
    if (tr.active) flush_pending(tr);
    total_dropped += tr.dropped;
    if (tr.n + 1 > max_len) max_len = tr.n + 1;  // +1 for END
    tr.unlock();
  }

  FILE* f = fopen(path, "wb");
  if (!f) {
    fprintf(stderr, "ptpu_capture: cannot open %s\n", path);
    return;
  }
  uint32_t line_bits = 0;
  for (int l = g_line; l > 1; l >>= 1) line_bits++;
  uint32_t hdr[5] = {PTPU_MAGIC, PTPU_VERSION, (uint32_t)n_cores,
                     (uint32_t)max_len,
                     FLAG_LINE_ADDRESSED | (line_bits << 8)};
  fwrite(hdr, sizeof(uint32_t), 5, f);
  for (int c = 0; c < n_cores; c++) {
    uint32_t len = (uint32_t)(g_threads[c].n + 1);
    fwrite(&len, sizeof(uint32_t), 1, f);
  }
  Event end{EV_END, 0, 0, 0};
  for (int c = 0; c < n_cores; c++) {
    ThreadRec& tr = g_threads[c];
    tr.lock();
    int64_t n = tr.n;  // freeze this row: no emits can interleave
    if (n) fwrite(tr.ev, sizeof(Event), (size_t)n, f);
    tr.unlock();
    for (int64_t i = n; i < max_len; i++) fwrite(&end, sizeof(Event), 1, f);
  }
  fclose(f);
  int64_t t_mem = 0, t_sync = 0, t_ins = 0;
  for (int c = 0; c < n_cores; c++) {
    t_mem += g_threads[c].n_mem;
    t_sync += g_threads[c].n_sync;
    t_ins += g_threads[c].n_ins;
  }
  fprintf(stderr,
          "ptpu_capture: wrote %s (%d threads, max %lld events%s%s)\n", path,
          n_cores, (long long)(max_len - 1),
          g_threads[0].tsc_fallback ? ", TSC-estimate INS" : ", perf INS",
          total_dropped ? ", EVENTS DROPPED at cap" : "");
  // capture-coverage honesty (SURVEY.md §2 #1): unlike Pin, this shim
  // sees memory traffic only at interposed library calls (mem*/str*) and
  // ptpu_annotate.h hooks — ordinary loads/stores appear solely inside
  // the instruction batches
  fprintf(stderr,
          "ptpu_capture: coverage: %lld mem-line events, %lld sync events, "
          "%lld instructions in batches; ordinary loads/stores OUTSIDE "
          "interposed calls/annotations are NOT captured as traffic\n",
          (long long)t_mem, (long long)t_sync, (long long)t_ins);
}

struct Init {
  Init() {
    resolve(real_pthread_create, "pthread_create");
    resolve(real_mutex_lock, "pthread_mutex_lock");
    resolve(real_mutex_trylock, "pthread_mutex_trylock");
    resolve(real_mutex_unlock, "pthread_mutex_unlock");
    resolve(real_barrier_init, "pthread_barrier_init");
    resolve(real_barrier_wait, "pthread_barrier_wait");
    resolve(real_memcpy, "memcpy");
    resolve(real_memset, "memset");
    if (const char* v = getenv("PTPU_MAX_CORES")) g_max_cores = atoi(v);
    if (const char* v = getenv("PTPU_MAX_EVENTS")) g_max_events = atoll(v);
    if (const char* v = getenv("PTPU_CAPTURE_MEMOPS"))
      g_capture_memops = atoi(v) != 0;
    if (const char* v = getenv("PTPU_LINE")) {
      int l = atoi(v);
      if (l > 0 && (l & (l - 1)) == 0)
        g_line = l;
      else
        fprintf(stderr, "ptpu_capture: PTPU_LINE=%s invalid (want a power "
                        "of two), using %d\n", v, g_line);
    }
    if (const char* v = getenv("PTPU_MEMOP_MAX_LINES"))
      g_memop_max_lines = atoi(v) > 0 ? atoi(v) : g_memop_max_lines;
    if (const char* ring = getenv("PTPU_RING_OUT"); ring && *ring) {
      if (const char* v = getenv("PTPU_RING_RECORDS")) {
        long r = atol(v);
        if (r >= 64) g_ring_records = (uint32_t)r;
      }
      if (const char* v = getenv("PTPU_RING_TIMEOUT_MS"))
        g_ring_timeout_ms = atoll(v);
      size_t bytes = sizeof(RingHeader) +
                     (size_t)g_max_cores * sizeof(RingCtl) +
                     (size_t)g_max_cores * g_ring_records * sizeof(Event);
      int fd = open(ring, O_RDWR | O_CREAT | O_TRUNC, 0644);
      if (fd >= 0 && ftruncate(fd, (off_t)bytes) == 0) {
        void* m = mmap(nullptr, bytes, PROT_READ | PROT_WRITE, MAP_SHARED,
                       fd, 0);
        if (m != MAP_FAILED) {
          memset(m, 0, sizeof(RingHeader) +
                           (size_t)g_max_cores * sizeof(RingCtl));
          g_ring_base = (uint8_t*)m;
          g_ring_ctl = (RingCtl*)(g_ring_base + sizeof(RingHeader));
          g_ring_data = (Event*)((uint8_t*)g_ring_ctl +
                                 (size_t)g_max_cores * sizeof(RingCtl));
          g_ring_hdr = (RingHeader*)g_ring_base;
          uint32_t line_bits = 0;
          for (int l = g_line; l > 1; l >>= 1) line_bits++;
          g_ring_hdr->max_cores = (uint32_t)g_max_cores;
          g_ring_hdr->records = g_ring_records;
          g_ring_hdr->line = (uint32_t)g_line;
          g_ring_hdr->flags = FLAG_LINE_ADDRESSED | (line_bits << 8);
          g_ring_hdr->version = RING_VERSION;
          // magic last, release: a host that sees the magic sees a fully
          // initialized header
          std::atomic_thread_fence(std::memory_order_release);
          g_ring_hdr->magic = RING_MAGIC;
          msync(m, sizeof(RingHeader), MS_SYNC);
        } else {
          fprintf(stderr, "ptpu_capture: mmap(%s) failed, offline mode\n",
                  ring);
        }
      } else {
        fprintf(stderr, "ptpu_capture: cannot create ring %s, offline mode\n",
                ring);
      }
      if (fd >= 0) close(fd);
    }
    g_threads = new ThreadRec[g_max_cores]();
    thread_register();  // main thread = core 0
  }
  ~Init() { write_trace(); }
};
Init g_init __attribute__((init_priority(150)));

struct TrampolineArg {
  void* (*fn)(void*);
  void* arg;
};

void* thread_trampoline(void* p) {
  TrampolineArg a = *(TrampolineArg*)p;
  free(p);
  thread_register();
  void* r = a.fn(a.arg);
  if (t_core >= 0) {
    // flush the thread's trailing instruction batch while it still runs
    // (t_in_shim: flush may realloc, whose memcpy would re-enter emit and
    // spin on the held tr.mu)
    ThreadRec& tr = g_threads[t_core];
    bool saved_in_shim = t_in_shim;
    t_in_shim = true;
    tr.lock();
    if (!g_shutdown.load(std::memory_order_relaxed)) flush_pending(tr);
    tr.active = false;
    if (g_ring_base)
      g_ring_ctl[t_core].state.store(RSTATE_DONE, std::memory_order_release);
    tr.unlock();
    t_in_shim = saved_in_shim;
  }
  return r;
}

}  // namespace

extern "C" {

int pthread_create(pthread_t* t, const pthread_attr_t* at, void* (*fn)(void*),
                   void* arg) {
  if (!real_pthread_create) resolve(real_pthread_create, "pthread_create");
  TrampolineArg* p = (TrampolineArg*)malloc(sizeof(TrampolineArg));
  p->fn = fn;
  p->arg = arg;
  return real_pthread_create(t, at, thread_trampoline, p);
}

int pthread_mutex_lock(pthread_mutex_t* m) {
  if (!real_mutex_lock) resolve(real_mutex_lock, "pthread_mutex_lock");
  if (t_core >= 0 && !t_in_shim) {
    t_in_shim = true;
    emit(EV_LOCK, 0, (int32_t)(((uintptr_t)m / (uintptr_t)g_line) & ADDR_MASK));
    t_in_shim = false;
  }
  return real_mutex_lock(m);
}

int pthread_mutex_trylock(pthread_mutex_t* m) {
  if (!real_mutex_trylock)
    resolve(real_mutex_trylock, "pthread_mutex_trylock");
  int r = real_mutex_trylock(m);
  if (r == 0 && t_core >= 0 && !t_in_shim) {
    t_in_shim = true;
    emit(EV_LOCK, 0, (int32_t)(((uintptr_t)m / (uintptr_t)g_line) & ADDR_MASK));
    t_in_shim = false;
  }
  return r;
}

int pthread_mutex_unlock(pthread_mutex_t* m) {
  if (!real_mutex_unlock) resolve(real_mutex_unlock, "pthread_mutex_unlock");
  if (t_core >= 0 && !t_in_shim) {
    t_in_shim = true;
    emit(EV_UNLOCK, 0, (int32_t)(((uintptr_t)m / (uintptr_t)g_line) & ADDR_MASK));
    t_in_shim = false;
  }
  return real_mutex_unlock(m);
}

int pthread_barrier_init(pthread_barrier_t* b, const pthread_barrierattr_t* at,
                         unsigned count) {
  if (!real_barrier_init) resolve(real_barrier_init, "pthread_barrier_init");
  barrier_register((void*)b, count);
  return real_barrier_init(b, at, count);
}

int pthread_barrier_wait(pthread_barrier_t* b) {
  if (!real_barrier_wait) resolve(real_barrier_wait, "pthread_barrier_wait");
  if (t_core >= 0 && !t_in_shim) {
    BarrierRec r = barrier_lookup((void*)b);
    if (r.id >= 0) {
      t_in_shim = true;
      emit(EV_BARRIER, r.count, r.id);
      t_in_shim = false;
    }
  }
  return real_barrier_wait(b);
}

void* memcpy(void* dst, const void* src, size_t n) {
  if (!real_memcpy) resolve(real_memcpy, "memcpy");
  if (g_capture_memops && t_core >= 0 && !t_in_shim && g_threads) {
    t_in_shim = true;
    emit_memops(EV_LD, src, n);
    emit_memops(EV_ST, dst, n);
    t_in_shim = false;
  }
  return real_memcpy(dst, src, n);
}

void* memset(void* dst, int v, size_t n) {
  if (!real_memset) resolve(real_memset, "memset");
  if (g_capture_memops && t_core >= 0 && !t_in_shim && g_threads) {
    t_in_shim = true;
    emit_memops(EV_ST, dst, n);
    t_in_shim = false;
  }
  return real_memset(dst, v, n);
}

// ---- wider interposition surface (VERDICT r4 #9): memmove/memcmp/str*
// calls are line-granular memory traffic exactly like memcpy. Each
// resolves its real entry lazily and guards recursion with t_in_shim.

void* memmove(void* dst, const void* src, size_t n) {
  static void* (*real)(void*, const void*, size_t) = nullptr;
  if (!real) resolve(real, "memmove");
  if (g_capture_memops && t_core >= 0 && !t_in_shim && g_threads) {
    t_in_shim = true;
    emit_memops(EV_LD, src, n);
    emit_memops(EV_ST, dst, n);
    t_in_shim = false;
  }
  return real(dst, src, n);
}

int memcmp(const void* a, const void* b, size_t n) {
  static int (*real)(const void*, const void*, size_t) = nullptr;
  if (!real) resolve(real, "memcmp");
  if (g_capture_memops && t_core >= 0 && !t_in_shim && g_threads) {
    t_in_shim = true;
    emit_memops(EV_LD, a, n);
    emit_memops(EV_LD, b, n);
    t_in_shim = false;
  }
  return real(a, b, n);
}

size_t strlen(const char* s) {
  static size_t (*real)(const char*) = nullptr;
  if (!real) resolve(real, "strlen");
  size_t n = real(s);
  if (g_capture_memops && t_core >= 0 && !t_in_shim && g_threads) {
    t_in_shim = true;
    emit_memops(EV_LD, s, n + 1);
    t_in_shim = false;
  }
  return n;
}

char* strcpy(char* dst, const char* src) {  // NOLINT
  static char* (*real)(char*, const char*) = nullptr;
  static size_t (*real_len)(const char*) = nullptr;
  if (!real) resolve(real, "strcpy");
  if (!real_len) resolve(real_len, "strlen");
  if (g_capture_memops && t_core >= 0 && !t_in_shim && g_threads) {
    t_in_shim = true;
    size_t n = real_len(src) + 1;
    emit_memops(EV_LD, src, n);
    emit_memops(EV_ST, dst, n);
    t_in_shim = false;
  }
  return real(dst, src);
}

char* strncpy(char* dst, const char* src, size_t n) {
  static char* (*real)(char*, const char*, size_t) = nullptr;
  if (!real) resolve(real, "strncpy");
  if (g_capture_memops && t_core >= 0 && !t_in_shim && g_threads) {
    t_in_shim = true;
    emit_memops(EV_LD, src, n);
    emit_memops(EV_ST, dst, n);
    t_in_shim = false;
  }
  return real(dst, src, n);
}

int strcmp(const char* a, const char* b) {
  static int (*real)(const char*, const char*) = nullptr;
  static size_t (*real_len)(const char*) = nullptr;
  if (!real) resolve(real, "strcmp");
  if (!real_len) resolve(real_len, "strlen");
  if (g_capture_memops && t_core >= 0 && !t_in_shim && g_threads) {
    t_in_shim = true;
    size_t n = real_len(a) + 1;
    emit_memops(EV_LD, a, n);
    emit_memops(EV_LD, b, n);
    t_in_shim = false;
  }
  return real(a, b);
}

// ---- user annotation hooks (frontend/ptpu_annotate.h) ---------------------
// An application (or an instrumented build) can report ORDINARY loads and
// stores the library-call surface cannot see. No-ops unless running under
// the shim.

void ptpu_capture_load(const void* p, size_t n) {
  if (t_core >= 0 && !t_in_shim && g_threads) {
    t_in_shim = true;
    emit_memops(EV_LD, p, n);
    t_in_shim = false;
  }
}

void ptpu_capture_store(const void* p, size_t n) {
  if (t_core >= 0 && !t_in_shim && g_threads) {
    t_in_shim = true;
    emit_memops(EV_ST, p, n);
    t_in_shim = false;
  }
}

}  // extern "C"
