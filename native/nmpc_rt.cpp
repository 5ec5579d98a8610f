// nmpc_rt — native host runtime for the NMPC engine.
//
// Replaces the reference's ROS1/rospy layer (SURVEY.md §1 L1, §5.8):
//   * rospy.Subscriber callbacks mutating Python globals  -> a seqlock-latched
//     topic bus: single-writer lock-free publish, tear-free latch on read.
//     The reference tolerates a data race between odom callbacks and the MPC
//     loop (six-robot file :19-77 vs :373); here latching is explicit and
//     race-free.
//   * TCPROS topic transport                              -> a minimal UDP
//     datagram transport (latest-value semantics fit control loops better
//     than TCP's in-order backlog) with a background receiver thread that
//     latches straight into the bus.
//   * time.sleep(T) pacing (drifts)                       -> a monotonic
//     deadline rate keeper (absolute schedule, no accumulated drift).
//
// Pure C ABI so Python binds via ctypes (no pybind11 in this image).

#include <atomic>
#include <chrono>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#include <arpa/inet.h>
#include <netinet/in.h>
#include <sys/socket.h>
#include <unistd.h>

namespace {

constexpr uint32_t kMagic = 0x4e4d5043;  // "NMPC"
constexpr int kMaxVals = 64;             // doubles per topic message

// Double-buffered seqlock topic. Publish k (1-based) writes slot (k & 1);
// once it completes (seq == 2k) the writer does not touch that slot again
// until publish k+2 BEGINS (seq == 2k+3). Readers therefore always have one
// full stable snapshot available even under a writer publishing in a tight
// loop — the failure mode a single-buffer seqlock has on an oversubscribed
// host (reader starved out of its validation window by a saturating writer).
struct Topic {
  std::atomic<uint64_t> seq{0};  // publishes started; odd = write in progress
  double data[2][kMaxVals];
  uint64_t stamp_ns[2] = {0, 0};
  int count[2] = {0, 0};
};

struct Bus {
  std::vector<Topic> topics;
  explicit Bus(int n) : topics(n) {}
};

struct Rate {
  std::chrono::steady_clock::time_point next;
  std::chrono::nanoseconds period;
  uint64_t missed{0};
};

struct UdpSub {
  int fd{-1};
  Bus* bus{nullptr};
  std::thread thr;
  std::atomic<bool> stop{false};
  std::atomic<uint64_t> received{0};
};

struct WireHeader {
  uint32_t magic;
  uint32_t topic;
  uint32_t count;
  uint32_t pad;
};

uint64_t now_ns() {
  return std::chrono::duration_cast<std::chrono::nanoseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

}  // namespace

extern "C" {

// ---------------- topic bus ----------------

void* nmpc_bus_create(int num_topics) { return new Bus(num_topics); }

void nmpc_bus_destroy(void* b) { delete static_cast<Bus*>(b); }

int nmpc_bus_publish(void* b, int topic, const double* data, int count) {
  Bus* bus = static_cast<Bus*>(b);
  if (topic < 0 || topic >= (int)bus->topics.size() || count > kMaxVals)
    return -1;
  Topic& t = bus->topics[topic];
  uint64_t s = t.seq.load(std::memory_order_relaxed);
  uint64_t k = s / 2 + 1;  // this publish's 1-based index
  int slot = (int)(k & 1);
  // Odd store is a RELEASE so a reader that observes it gets a
  // synchronizes-with edge to everything published before (under relaxed,
  // visibility of the stable slot's data would rest on hardware behavior
  // rather than the C++ memory model — advisor round 4). Costs nothing:
  // on x86/ARM a release store compiles to the same plain/stlr store.
  t.seq.store(s + 1, std::memory_order_release);  // odd: writing `slot`
  // Full fence: the slot writes below must not be reordered before the odd
  // store (a release store alone does not order SUBSEQUENT plain writes).
  std::atomic_thread_fence(std::memory_order_seq_cst);
  std::memcpy(t.data[slot], data, sizeof(double) * count);
  t.count[slot] = count;
  t.stamp_ns[slot] = now_ns();
  t.seq.store(s + 2, std::memory_order_release);  // even: publish k complete
  return 0;
}

// Tear-free latch of the latest stable value. Returns the element count
// (0 if the topic has never completed a publish), or -1 on bad args.
//
// Double buffering makes this effectively wait-free for the reader: the last
// COMPLETED publish kc lives in slot (kc & 1), which the writer will not
// touch again until publish kc+2 begins (seq >= 2*kc+3). A retry is needed
// only if the writer completes a publish AND starts another while this
// reader is inside one small memcpy; the backoff below (yield, then
// microsleeps) makes repeated collisions vanishingly unlikely even with a
// tight-spinning writer on an oversubscribed host. A latch can therefore
// return a slightly stale-but-consistent snapshot instead of failing —
// exactly the semantics a control loop wants from a busy odometry topic.
int nmpc_bus_latch(void* b, int topic, double* out, int max_count,
                   uint64_t* stamp_ns) {
  Bus* bus = static_cast<Bus*>(b);
  if (topic < 0 || topic >= (int)bus->topics.size()) return -1;
  Topic& t = bus->topics[topic];
  for (int attempt = 0; attempt < 1000; ++attempt) {
    if (attempt >= 4) {
      if (attempt < 16) {
        std::this_thread::yield();
      } else {
        int shift = attempt - 16 < 7 ? attempt - 16 : 7;  // cap 128 us
        std::this_thread::sleep_for(std::chrono::microseconds(1 << shift));
      }
    }
    uint64_t s0 = t.seq.load(std::memory_order_acquire);
    uint64_t kc = s0 / 2;  // last completed publish (0 if none)
    if (kc == 0) return 0;
    int slot = (int)(kc & 1);
    int n = t.count[slot] < max_count ? t.count[slot] : max_count;
    double tmp[kMaxVals];
    std::memcpy(tmp, t.data[slot], sizeof(double) * n);
    uint64_t stamp = t.stamp_ns[slot];
    std::atomic_thread_fence(std::memory_order_acquire);
    uint64_t s1 = t.seq.load(std::memory_order_relaxed);
    if (s1 < 2 * kc + 3) {  // publish kc+2 not started: slot was stable
      std::memcpy(out, tmp, sizeof(double) * n);
      if (stamp_ns) *stamp_ns = stamp;
      return n;
    }
  }
  return -2;  // unreachable in practice (see wait-freedom note above)
}

// ---------------- UDP transport ----------------

int nmpc_udp_pub_open(const char* host, int port) {
  int fd = socket(AF_INET, SOCK_DGRAM, 0);
  if (fd < 0) return -1;
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(port);
  if (inet_pton(AF_INET, host, &addr.sin_addr) != 1) {
    close(fd);
    return -1;
  }
  if (connect(fd, (sockaddr*)&addr, sizeof(addr)) != 0) {
    close(fd);
    return -1;
  }
  return fd;
}

int nmpc_udp_send(int fd, int topic, const double* data, int count) {
  if (count > kMaxVals) return -1;
  char buf[sizeof(WireHeader) + sizeof(double) * kMaxVals];
  WireHeader h{kMagic, (uint32_t)topic, (uint32_t)count, 0};
  std::memcpy(buf, &h, sizeof(h));
  std::memcpy(buf + sizeof(h), data, sizeof(double) * count);
  ssize_t n = send(fd, buf, sizeof(h) + sizeof(double) * count, 0);
  return n < 0 ? -1 : 0;
}

void nmpc_udp_close(int fd) { close(fd); }

// Subscriber: background thread latches incoming datagrams into `bus`.
void* nmpc_udp_sub_open(int port, void* bus) {
  UdpSub* s = new UdpSub();
  s->bus = static_cast<Bus*>(bus);
  s->fd = socket(AF_INET, SOCK_DGRAM, 0);
  if (s->fd < 0) {
    delete s;
    return nullptr;
  }
  int one = 1;
  setsockopt(s->fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  timeval tv{0, 100000};  // 100 ms poll so stop is responsive
  setsockopt(s->fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(port);
  addr.sin_addr.s_addr = htonl(INADDR_ANY);
  if (bind(s->fd, (sockaddr*)&addr, sizeof(addr)) != 0) {
    close(s->fd);
    delete s;
    return nullptr;
  }
  s->thr = std::thread([s]() {
    char buf[sizeof(WireHeader) + sizeof(double) * kMaxVals];
    while (!s->stop.load(std::memory_order_relaxed)) {
      ssize_t n = recv(s->fd, buf, sizeof(buf), 0);
      if (n < (ssize_t)sizeof(WireHeader)) continue;
      WireHeader h;
      std::memcpy(&h, buf, sizeof(h));
      if (h.magic != kMagic || h.count > kMaxVals) continue;
      if ((size_t)n < sizeof(h) + sizeof(double) * h.count) continue;
      nmpc_bus_publish(s->bus, (int)h.topic,
                       reinterpret_cast<double*>(buf + sizeof(h)),
                       (int)h.count);
      s->received.fetch_add(1, std::memory_order_relaxed);
    }
  });
  return s;
}

uint64_t nmpc_udp_sub_received(void* sub) {
  return static_cast<UdpSub*>(sub)->received.load(std::memory_order_relaxed);
}

void nmpc_udp_sub_close(void* sub) {
  UdpSub* s = static_cast<UdpSub*>(sub);
  s->stop.store(true);
  if (s->thr.joinable()) s->thr.join();
  close(s->fd);
  delete s;
}

// ---------------- rate keeper ----------------

void* nmpc_rate_create(double period_s) {
  Rate* r = new Rate();
  r->period = std::chrono::nanoseconds((int64_t)(period_s * 1e9));
  r->next = std::chrono::steady_clock::now() + r->period;
  return r;
}

// Sleep until the next absolute deadline; returns missed-deadline count so
// far. Deadlines advance on the absolute schedule (no drift accumulation).
uint64_t nmpc_rate_sleep(void* rp) {
  Rate* r = static_cast<Rate*>(rp);
  auto now = std::chrono::steady_clock::now();
  while (now >= r->next) {  // missed one or more periods: skip forward
    r->next += r->period;
    if (now >= r->next) r->missed++;
  }
  std::this_thread::sleep_until(r->next);
  r->next += r->period;
  return r->missed;
}

void nmpc_rate_destroy(void* rp) { delete static_cast<Rate*>(rp); }

uint64_t nmpc_now_ns() { return now_ns(); }

}  // extern "C"
