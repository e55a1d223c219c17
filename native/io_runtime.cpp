// Native streaming I/O runtime for the JAX receiver.
//
// Redesign of the reference's host-side concurrency layer
// (include/threadsafequeue.h single-slot rendezvous + the blocking
// std::cin.read in src/rffrontend.cpp:48 and fwrite in src/mono.cpp:45):
// on this architecture the DSP consumers are fused on the accelerator, so
// the host side needs exactly two things, each running on its own thread so
// pipe stalls never block device dispatch:
//
//   * a block READER: pulls fixed-size IQ blocks from an fd into a ring
//     buffer. Depth-1 ring + blocking push == the reference's rendezvous
//     backpressure; deeper rings smooth jitter; "drop oldest" mode keeps
//     real-time receivers current when the consumer falls behind.
//   * a PCM WRITER: drains a ring of audio blocks to an fd.
//
// Lifetime: the worker threads share ownership of the ring state
// (shared_ptr) and may outlive the Python-facing handle — a reader blocked
// in ::read() on a live pipe cannot be joined, so close() flags stop,
// detaches, and lets the thread release its reference when it wakes.
//
// Exposed as a C API for ctypes (no pybind11 in this image).

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>

#include <errno.h>
#include <unistd.h>

namespace {

struct Ring {
  std::vector<std::vector<uint8_t>> slots;
  std::vector<size_t> sizes;       // bytes valid in each slot
  size_t head = 0;                 // next slot to read
  size_t count = 0;                // filled slots
  bool eof = false;
  bool drop_oldest = false;
  uint64_t dropped = 0;
  std::atomic<bool> stop{false};
  std::mutex mu;
  std::condition_variable not_empty;
  std::condition_variable not_full;

  Ring(size_t depth, size_t block_bytes, bool drop)
      : slots(depth, std::vector<uint8_t>(block_bytes)),
        sizes(depth, 0), drop_oldest(drop) {}
};

// Blocking full read of exactly n bytes (short only at EOF/error).
static size_t read_full(int fd, uint8_t* dst, size_t n) {
  size_t got = 0;
  while (got < n) {
    ssize_t r = ::read(fd, dst + got, n - got);
    if (r < 0) {
      if (errno == EINTR) continue;
      break;
    }
    if (r == 0) break;  // EOF
    got += static_cast<size_t>(r);
  }
  return got;
}

static size_t write_full(int fd, const uint8_t* src, size_t n) {
  size_t put = 0;
  while (put < n) {
    ssize_t w = ::write(fd, src + put, n - put);
    if (w < 0) {
      if (errno == EINTR) continue;
      break;
    }
    put += static_cast<size_t>(w);
  }
  return put;
}

static void reader_loop(std::shared_ptr<Ring> ring, int fd,
                        size_t block_bytes) {
  std::vector<uint8_t> buf(block_bytes);
  while (!ring->stop.load()) {
    size_t got = read_full(fd, buf.data(), block_bytes);
    std::unique_lock<std::mutex> lk(ring->mu);
    if (got < block_bytes) {  // EOF (reference: exit(1) on cin.eof())
      ring->eof = true;
      ring->not_empty.notify_all();
      return;
    }
    if (ring->count == ring->slots.size()) {
      if (ring->drop_oldest) {
        ring->head = (ring->head + 1) % ring->slots.size();
        ring->count--;
        ring->dropped++;
      } else {
        ring->not_full.wait(lk, [&] {
          return ring->count < ring->slots.size() || ring->stop.load();
        });
        if (ring->stop.load()) return;
      }
    }
    size_t tail = (ring->head + ring->count) % ring->slots.size();
    std::memcpy(ring->slots[tail].data(), buf.data(), block_bytes);
    ring->sizes[tail] = block_bytes;
    ring->count++;
    ring->not_empty.notify_one();
  }
}

struct Reader {
  std::shared_ptr<Ring> ring;
  size_t block_bytes;

  Reader(int fd, size_t block_bytes_, size_t depth, bool drop_oldest)
      : ring(std::make_shared<Ring>(depth, block_bytes_, drop_oldest)),
        block_bytes(block_bytes_) {
    std::thread(reader_loop, ring, fd, block_bytes_).detach();
  }

  // Returns bytes copied (0 at end of stream).
  size_t next(uint8_t* out) {
    std::unique_lock<std::mutex> lk(ring->mu);
    ring->not_empty.wait(lk, [&] { return ring->count > 0 || ring->eof; });
    if (ring->count == 0) return 0;
    std::memcpy(out, ring->slots[ring->head].data(), block_bytes);
    ring->head = (ring->head + 1) % ring->slots.size();
    ring->count--;
    ring->not_full.notify_one();
    return block_bytes;
  }

  ~Reader() {
    ring->stop.store(true);
    ring->not_full.notify_all();
    // The thread holds its own shared_ptr; if it is blocked in ::read() it
    // simply exits (or leaks harmlessly until process end) when it wakes.
  }
};

static void writer_loop(std::shared_ptr<Ring> ring, int fd) {
  while (true) {
    std::unique_lock<std::mutex> lk(ring->mu);
    ring->not_empty.wait(lk, [&] {
      return ring->count > 0 || ring->stop.load();
    });
    if (ring->count == 0) {
      if (ring->stop.load()) return;
      continue;
    }
    size_t idx = ring->head;
    size_t n = ring->sizes[idx];
    std::vector<uint8_t> local(ring->slots[idx].begin(),
                               ring->slots[idx].begin() + n);
    lk.unlock();
    write_full(fd, local.data(), n);
    lk.lock();
    ring->head = (ring->head + 1) % ring->slots.size();
    ring->count--;
    ring->not_full.notify_all();
  }
}

struct Writer {
  std::shared_ptr<Ring> ring;
  size_t block_bytes;

  Writer(int fd, size_t block_bytes_, size_t depth)
      : ring(std::make_shared<Ring>(depth, block_bytes_, false)),
        block_bytes(block_bytes_) {
    std::thread(writer_loop, ring, fd).detach();
  }

  // Returns 0 on success, -1 if n exceeds the slot capacity (rejected —
  // a silent memcpy past block_bytes would corrupt the heap).
  int push(const uint8_t* data, size_t n) {
    if (n > block_bytes) return -1;
    std::unique_lock<std::mutex> lk(ring->mu);
    ring->not_full.wait(lk, [&] { return ring->count < ring->slots.size(); });
    size_t tail = (ring->head + ring->count) % ring->slots.size();
    std::memcpy(ring->slots[tail].data(), data, n);
    ring->sizes[tail] = n;
    ring->count++;
    ring->not_empty.notify_one();
    return 0;
  }

  void drain() {
    std::unique_lock<std::mutex> lk(ring->mu);
    ring->not_full.wait(lk, [&] { return ring->count == 0; });
  }

  ~Writer() {
    drain();
    ring->stop.store(true);
    ring->not_empty.notify_all();
  }
};

}  // namespace

extern "C" {

void* rtsdr_reader_open(int fd, size_t block_bytes, size_t depth,
                        int drop_oldest) {
  // depth 0 would mean modulo-by-zero (drop-oldest) or a never-true wait
  // predicate (blocking); a ring needs at least one slot.
  if (depth < 1) depth = 1;
  return new Reader(fd, block_bytes, depth, drop_oldest != 0);
}

// Returns block_bytes on success, 0 at end of stream.
size_t rtsdr_reader_next(void* handle, uint8_t* out) {
  return static_cast<Reader*>(handle)->next(out);
}

uint64_t rtsdr_reader_dropped(void* handle) {
  Reader* r = static_cast<Reader*>(handle);
  std::unique_lock<std::mutex> lk(r->ring->mu);
  return r->ring->dropped;
}

void rtsdr_reader_close(void* handle) {
  delete static_cast<Reader*>(handle);
}

void* rtsdr_writer_open(int fd, size_t max_block_bytes, size_t depth) {
  if (depth < 1) depth = 1;
  return new Writer(fd, max_block_bytes, depth);
}

// Returns 0 on success, -1 if the block exceeds the writer's capacity.
int rtsdr_writer_push(void* handle, const uint8_t* data, size_t n) {
  return static_cast<Writer*>(handle)->push(data, n);
}

void rtsdr_writer_close(void* handle) {
  delete static_cast<Writer*>(handle);  // drains first
}

}  // extern "C"
