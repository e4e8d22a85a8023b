// Process-shared-memory ring channel for the DataLoader's worker processes
// (the port's copy of the reference's csrc/shm_channel.cc, with what it
// calls from csrc/flags.cc and csrc/common.h: pd_free, pd_last_error and
// the thread-local last-error slot; the reference's host allocator stats
// are left out, as nothing in the port reads them).
//
// Design: one shm segment = header + byte ring. The header embeds a
// PTHREAD_PROCESS_SHARED mutex and two condvars. Messages are
// [u64 len][payload] with wraparound. Multiple producers (workers), one or
// more consumers. close_write() sets a flag so readers drain, then stop.
//
// Built with the host compiler, no CUDA:
//   g++ -O2 -std=c++17 -fPIC -pthread -shared shm_channel.cc -lrt
#include <fcntl.h>
#include <pthread.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include <algorithm>
#include <cerrno>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <ctime>
#include <string>

#define PD_EXPORT extern "C" __attribute__((visibility("default")))

namespace {

thread_local std::string g_last_error;

void set_last_error(const std::string& msg) { g_last_error = msg; }

struct Header {
  uint64_t magic;
  uint64_t capacity;   // ring bytes
  uint64_t head;       // read offset  (mod capacity)
  uint64_t tail;       // write offset (mod capacity)
  uint64_t used;       // bytes currently in ring
  uint32_t closed;
  uint32_t _pad;
  pthread_mutex_t mu;
  pthread_cond_t not_empty;
  pthread_cond_t not_full;
};

constexpr uint64_t kMagic = 0x70645f73686d3031ull;  // "pd_shm01"

struct Handle {
  Header* h = nullptr;
  uint8_t* ring = nullptr;
  uint64_t map_len = 0;
  std::string name;
  bool owner = false;
};

void ring_write(Handle* hd, const uint8_t* src, uint64_t n) {
  Header* h = hd->h;
  uint64_t t = h->tail;
  uint64_t first = std::min(n, h->capacity - t);
  std::memcpy(hd->ring + t, src, first);
  if (n > first) std::memcpy(hd->ring, src + first, n - first);
  h->tail = (t + n) % h->capacity;
  h->used += n;
}

void ring_read(Handle* hd, uint8_t* dst, uint64_t n) {
  Header* h = hd->h;
  uint64_t hd_off = h->head;
  uint64_t first = std::min(n, h->capacity - hd_off);
  std::memcpy(dst, hd->ring + hd_off, first);
  if (n > first) std::memcpy(dst + first, hd->ring, n - first);
  h->head = (hd_off + n) % h->capacity;
  h->used -= n;
}

timespec deadline_after(int timeout_ms) {
  timespec ts;
  clock_gettime(CLOCK_REALTIME, &ts);
  ts.tv_sec += timeout_ms / 1000;
  ts.tv_nsec += static_cast<long>(timeout_ms % 1000) * 1000000L;
  if (ts.tv_nsec >= 1000000000L) {
    ts.tv_sec += 1;
    ts.tv_nsec -= 1000000000L;
  }
  return ts;
}

}  // namespace

PD_EXPORT const char* pd_last_error() { return g_last_error.c_str(); }

PD_EXPORT void pd_free(void* p) { std::free(p); }

PD_EXPORT void* pd_shm_create(const char* name, int64_t capacity) {
  ::shm_unlink(name);  // stale segment from a crashed run
  int fd = ::shm_open(name, O_CREAT | O_EXCL | O_RDWR, 0600);
  if (fd < 0) {
    set_last_error("shm_open(create) failed");
    return nullptr;
  }
  uint64_t total = sizeof(Header) + static_cast<uint64_t>(capacity);
  if (::ftruncate(fd, static_cast<off_t>(total)) != 0) {
    set_last_error("ftruncate failed");
    ::close(fd);
    ::shm_unlink(name);
    return nullptr;
  }
  void* mem = ::mmap(nullptr, total, PROT_READ | PROT_WRITE, MAP_SHARED, fd,
                     0);
  ::close(fd);
  if (mem == MAP_FAILED) {
    set_last_error("mmap failed");
    ::shm_unlink(name);
    return nullptr;
  }
  auto* h = static_cast<Header*>(mem);
  h->capacity = static_cast<uint64_t>(capacity);
  h->head = h->tail = h->used = 0;
  h->closed = 0;
  pthread_mutexattr_t ma;
  pthread_mutexattr_init(&ma);
  pthread_mutexattr_setpshared(&ma, PTHREAD_PROCESS_SHARED);
  pthread_mutex_init(&h->mu, &ma);
  pthread_condattr_t ca;
  pthread_condattr_init(&ca);
  pthread_condattr_setpshared(&ca, PTHREAD_PROCESS_SHARED);
  pthread_cond_init(&h->not_empty, &ca);
  pthread_cond_init(&h->not_full, &ca);
  h->magic = kMagic;  // last: marks segment initialized
  auto* hd = new Handle();
  hd->h = h;
  hd->ring = static_cast<uint8_t*>(mem) + sizeof(Header);
  hd->map_len = total;
  hd->name = name;
  hd->owner = true;
  return hd;
}

PD_EXPORT void* pd_shm_open(const char* name) {
  int fd = ::shm_open(name, O_RDWR, 0600);
  if (fd < 0) {
    set_last_error("shm_open failed (segment missing)");
    return nullptr;
  }
  struct stat st;
  if (::fstat(fd, &st) != 0 || st.st_size < (off_t)sizeof(Header)) {
    set_last_error("shm segment bad size");
    ::close(fd);
    return nullptr;
  }
  void* mem = ::mmap(nullptr, static_cast<size_t>(st.st_size),
                     PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  ::close(fd);
  if (mem == MAP_FAILED) {
    set_last_error("mmap failed");
    return nullptr;
  }
  auto* h = static_cast<Header*>(mem);
  if (h->magic != kMagic) {
    set_last_error("shm segment not initialized");
    ::munmap(mem, static_cast<size_t>(st.st_size));
    return nullptr;
  }
  auto* hd = new Handle();
  hd->h = h;
  hd->ring = static_cast<uint8_t*>(mem) + sizeof(Header);
  hd->map_len = static_cast<uint64_t>(st.st_size);
  hd->name = name;
  hd->owner = false;
  return hd;
}

// Push one message. Blocks while the ring is full. 0 ok, -1 timeout/closed,
// -2 message larger than the ring.
PD_EXPORT int pd_shm_push(void* hv, const uint8_t* data, int64_t len,
                          int timeout_ms) {
  auto* hd = static_cast<Handle*>(hv);
  Header* h = hd->h;
  uint64_t need = 8 + static_cast<uint64_t>(len);
  if (need > h->capacity) {
    set_last_error("message larger than ring capacity");
    return -2;
  }
  timespec dl = deadline_after(timeout_ms);
  pthread_mutex_lock(&h->mu);
  while (h->capacity - h->used < need && !h->closed) {
    if (pthread_cond_timedwait(&h->not_full, &h->mu, &dl) == ETIMEDOUT) {
      pthread_mutex_unlock(&h->mu);
      set_last_error("shm push timeout");
      return -1;
    }
  }
  if (h->closed) {
    pthread_mutex_unlock(&h->mu);
    set_last_error("channel closed");
    return -1;
  }
  uint64_t n = static_cast<uint64_t>(len);
  ring_write(hd, reinterpret_cast<const uint8_t*>(&n), 8);
  ring_write(hd, data, n);
  pthread_cond_signal(&h->not_empty);
  pthread_mutex_unlock(&h->mu);
  return 0;
}

// Pop one message into a malloc'd buffer (*out, free with pd_free).
// Returns length >=0, -1 on timeout, -3 when closed AND drained.
PD_EXPORT int64_t pd_shm_pop(void* hv, uint8_t** out, int timeout_ms) {
  auto* hd = static_cast<Handle*>(hv);
  Header* h = hd->h;
  timespec dl = deadline_after(timeout_ms);
  pthread_mutex_lock(&h->mu);
  while (h->used == 0) {
    if (h->closed) {
      pthread_mutex_unlock(&h->mu);
      return -3;
    }
    if (pthread_cond_timedwait(&h->not_empty, &h->mu, &dl) == ETIMEDOUT) {
      pthread_mutex_unlock(&h->mu);
      set_last_error("shm pop timeout");
      return -1;
    }
  }
  uint64_t n;
  ring_read(hd, reinterpret_cast<uint8_t*>(&n), 8);
  *out = static_cast<uint8_t*>(std::malloc(n ? n : 1));
  ring_read(hd, *out, n);
  pthread_cond_signal(&h->not_full);
  pthread_mutex_unlock(&h->mu);
  return static_cast<int64_t>(n);
}

PD_EXPORT void pd_shm_close_write(void* hv) {
  auto* hd = static_cast<Handle*>(hv);
  pthread_mutex_lock(&hd->h->mu);
  hd->h->closed = 1;
  pthread_cond_broadcast(&hd->h->not_empty);
  pthread_cond_broadcast(&hd->h->not_full);
  pthread_mutex_unlock(&hd->h->mu);
}

PD_EXPORT void pd_shm_free(void* hv, int unlink) {
  auto* hd = static_cast<Handle*>(hv);
  ::munmap(hd->h, hd->map_len);
  if (unlink) ::shm_unlink(hd->name.c_str());
  delete hd;
}
