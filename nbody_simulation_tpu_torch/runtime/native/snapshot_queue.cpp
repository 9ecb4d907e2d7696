// Native bounded lossy snapshot queue — the port's equivalent of the
// reference's `flume::bounded(2)` sim→render channel (reference
// src/main.rs:101-146): the producer drops snapshots when the queue is full
// (`!tx.is_full() && try_send`, src/main.rs:136-139) so physics never blocks
// on rendering; the consumer blocks on pop (`rx.recv()`, src/main.rs:146).
//
// Exposed as a C ABI for ctypes. Fixed-capacity ring of byte slots; one
// mutex + condvar (contention is two threads at ~60 Hz — negligible).

#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <vector>

namespace {

struct SnapshotQueue {
  std::mutex mu;
  std::condition_variable cv;
  std::vector<std::vector<uint8_t>> slots;
  std::vector<size_t> sizes;
  size_t cap;
  size_t slot_bytes;
  size_t head = 0;   // next slot to pop
  size_t count = 0;  // occupied slots
  uint64_t pushed = 0;
  uint64_t dropped = 0;
  bool closed = false;
};

}  // namespace

extern "C" {

void* sq_create(size_t capacity, size_t slot_bytes) {
  auto* q = new SnapshotQueue();
  q->cap = capacity;
  q->slot_bytes = slot_bytes;
  q->slots.resize(capacity);
  q->sizes.assign(capacity, 0);
  for (auto& s : q->slots) s.resize(slot_bytes);
  return q;
}

// Returns 1 if enqueued, 0 if dropped (full/oversized/closed).
int sq_try_push(void* vq, const uint8_t* data, size_t len) {
  auto* q = static_cast<SnapshotQueue*>(vq);
  if (len > q->slot_bytes) {
    // Oversized payloads count as drops, matching the Python fallback's
    // semantics (runtime/queue.py) so Engine.dropped agrees on both paths.
    std::lock_guard<std::mutex> lk(q->mu);
    q->dropped++;
    return 0;
  }
  {
    std::lock_guard<std::mutex> lk(q->mu);
    if (q->closed || q->count == q->cap) {
      q->dropped++;
      return 0;
    }
    size_t tail = (q->head + q->count) % q->cap;
    std::memcpy(q->slots[tail].data(), data, len);
    q->sizes[tail] = len;
    q->count++;
    q->pushed++;
  }
  q->cv.notify_one();
  return 1;
}

// Blocks up to timeout_ms (<0 = forever). Returns payload size, or
// -1 on timeout, -2 if closed and drained, -3 if out buffer too small.
long sq_pop(void* vq, uint8_t* out, size_t out_len, long timeout_ms) {
  auto* q = static_cast<SnapshotQueue*>(vq);
  std::unique_lock<std::mutex> lk(q->mu);
  auto ready = [q] { return q->count > 0 || q->closed; };
  if (timeout_ms < 0) {
    q->cv.wait(lk, ready);
  } else if (!q->cv.wait_for(lk, std::chrono::milliseconds(timeout_ms),
                             ready)) {
    return -1;
  }
  if (q->count == 0) return -2;  // closed and drained
  size_t len = q->sizes[q->head];
  if (len > out_len) return -3;
  std::memcpy(out, q->slots[q->head].data(), len);
  q->head = (q->head + 1) % q->cap;
  q->count--;
  return static_cast<long>(len);
}

uint64_t sq_pushed(void* vq) {
  auto* q = static_cast<SnapshotQueue*>(vq);
  std::lock_guard<std::mutex> lk(q->mu);
  return q->pushed;
}

uint64_t sq_dropped(void* vq) {
  auto* q = static_cast<SnapshotQueue*>(vq);
  std::lock_guard<std::mutex> lk(q->mu);
  return q->dropped;
}

size_t sq_len(void* vq) {
  auto* q = static_cast<SnapshotQueue*>(vq);
  std::lock_guard<std::mutex> lk(q->mu);
  return q->count;
}

int sq_is_full(void* vq) {
  auto* q = static_cast<SnapshotQueue*>(vq);
  std::lock_guard<std::mutex> lk(q->mu);
  return q->count == q->cap ? 1 : 0;
}

void sq_close(void* vq) {
  auto* q = static_cast<SnapshotQueue*>(vq);
  {
    std::lock_guard<std::mutex> lk(q->mu);
    q->closed = true;
  }
  q->cv.notify_all();
}

void sq_destroy(void* vq) { delete static_cast<SnapshotQueue*>(vq); }

}  // extern "C"
