// Native TCP IQ ingest server (host data plane).
//
// (reference capability: the live-sample ingestion side of
// LTE_fdd_dl_scan / LTE_fdd_enodeb — gr-osmosdr sources and the UHD
// rx_streamer loop pulling complex samples off hardware into ring
// buffers, with overrun accounting.  SDR hardware is out of scope
// (BASELINE), so the transport is TCP: any sample server — rtl_tcp-style
// daemons, a remote recorder, another process — can feed the scanner at
// line rate without the GIL in the receive path.)
//
// One server accepts ONE client at a time; a background thread converts
// incoming sc8/sc16/fc32 samples to float32 I/Q and pushes them into a
// single-producer single-consumer ring.  When the consumer falls behind,
// incoming samples are dropped and counted (the reference logs radio
// overruns the same way).
//
// Build: make -C lteax/native    Python binding: lteax/io/native.py.

#include <arpa/inet.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <unistd.h>

#include <atomic>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <condition_variable>
#include <thread>

extern "C" {
void iq_sc8_to_f32(const int8_t*, float*, int64_t);
void iq_sc16_to_f32(const int16_t*, float*, int64_t);

struct IqTcp {
  int listen_fd = -1;
  std::atomic<int> conn_fd{-1};
  int fmt = 0;                    // 0 fc32, 1 sc8, 2 sc16
  uint16_t port = 0;
  int64_t cap = 0;                // ring capacity, complex samples
  float* ring = nullptr;          // 2*cap floats
  std::atomic<int64_t> head{0};   // written complex samples (producer)
  std::atomic<int64_t> tail{0};   // consumed complex samples (consumer)
  std::atomic<int64_t> dropped{0};
  std::atomic<bool> stop{false};
  std::mutex mu;
  std::condition_variable cv;
  std::thread th;
};

static void iq_tcp_worker(IqTcp* s) {
  const int itemsize = s->fmt == 0 ? 8 : (s->fmt == 1 ? 2 : 4);
  const int64_t CH = 1 << 15;     // complex samples per recv batch
  char* raw = (char*)malloc((size_t)CH * itemsize);
  float* conv = (float*)malloc((size_t)CH * 8);
  while (!s->stop.load()) {
    int fd = accept(s->listen_fd, nullptr, nullptr);
    if (fd < 0) break;            // listen socket closed
    int one = 1;
    setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
    s->conn_fd.store(fd);
    int64_t carry = 0;            // partial item bytes carried over
    while (!s->stop.load()) {
      ssize_t got = recv(fd, raw + carry, (size_t)(CH * itemsize - carry), 0);
      if (got <= 0) break;
      int64_t bytes = carry + got;
      int64_t n = bytes / itemsize;      // whole complex samples
      carry = bytes - n * itemsize;
      if (n == 0) continue;
      if (s->fmt == 0)
        memcpy(conv, raw, (size_t)n * 8);
      else if (s->fmt == 1)
        iq_sc8_to_f32((const int8_t*)raw, conv, n * 2);
      else
        iq_sc16_to_f32((const int16_t*)raw, conv, n * 2);
      if (carry) memmove(raw, raw + n * itemsize, (size_t)carry);
      // push into the ring; drop (and count) what does not fit
      int64_t h = s->head.load(std::memory_order_relaxed);
      int64_t t = s->tail.load(std::memory_order_acquire);
      int64_t space = s->cap - (h - t);
      int64_t take = n < space ? n : space;
      for (int64_t i = 0; i < take; ++i) {
        int64_t slot = (h + i) % s->cap;
        s->ring[2 * slot] = conv[2 * i];
        s->ring[2 * slot + 1] = conv[2 * i + 1];
      }
      s->head.store(h + take, std::memory_order_release);
      if (take < n) s->dropped.fetch_add(n - take);
      s->cv.notify_one();
    }
    close(fd);
    s->conn_fd.store(-1);
    s->cv.notify_all();
  }
  free(raw);
  free(conv);
}

// Open a server on `port` (0 = ephemeral).  Returns handle or null.
void* iq_tcp_open(uint16_t port, int fmt, int64_t ring_samples) {
  int fd = socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return nullptr;
  int one = 1;
  setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_LOOPBACK);
  addr.sin_port = htons(port);
  if (bind(fd, (sockaddr*)&addr, sizeof(addr)) != 0 || listen(fd, 1) != 0) {
    close(fd);
    return nullptr;
  }
  socklen_t alen = sizeof(addr);
  getsockname(fd, (sockaddr*)&addr, &alen);
  IqTcp* s = new IqTcp();
  s->listen_fd = fd;
  s->fmt = fmt;
  s->port = ntohs(addr.sin_port);
  s->cap = ring_samples;
  s->ring = (float*)malloc((size_t)ring_samples * 8);
  s->th = std::thread(iq_tcp_worker, s);
  return s;
}

int iq_tcp_port(void* h) { return ((IqTcp*)h)->port; }
int iq_tcp_connected(void* h) { return ((IqTcp*)h)->conn_fd.load() >= 0; }
int64_t iq_tcp_dropped(void* h) { return ((IqTcp*)h)->dropped.load(); }

// Pop up to max_samples complex samples into out (float32 I/Q pairs).
// Blocks up to timeout_ms for data; returns the count (0 on timeout or
// closed+drained).
int64_t iq_tcp_read(void* h, float* out, int64_t max_samples,
                    int timeout_ms) {
  IqTcp* s = (IqTcp*)h;
  int64_t t = s->tail.load(std::memory_order_relaxed);
  if (s->head.load(std::memory_order_acquire) == t) {
    std::unique_lock<std::mutex> lk(s->mu);
    s->cv.wait_for(lk, std::chrono::milliseconds(timeout_ms), [&] {
      return s->head.load() != t || s->stop.load();
    });
  }
  int64_t hd = s->head.load(std::memory_order_acquire);
  int64_t n = hd - t;
  if (n > max_samples) n = max_samples;
  for (int64_t i = 0; i < n; ++i) {
    int64_t slot = (t + i) % s->cap;
    out[2 * i] = s->ring[2 * slot];
    out[2 * i + 1] = s->ring[2 * slot + 1];
  }
  s->tail.store(t + n, std::memory_order_release);
  return n;
}

void iq_tcp_close(void* h) {
  IqTcp* s = (IqTcp*)h;
  s->stop.store(true);
  int cfd = s->conn_fd.load();
  if (cfd >= 0) shutdown(cfd, SHUT_RDWR);
  if (s->listen_fd >= 0) {
    shutdown(s->listen_fd, SHUT_RDWR);
    close(s->listen_fd);
  }
  s->cv.notify_all();
  if (s->th.joinable()) s->th.join();
  free(s->ring);
  delete s;
}

}  // extern "C"
