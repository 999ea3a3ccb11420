// Single-producer / single-consumer frame ring buffer with explicit tick
// semantics (C++).
//
// Replaces the reference's unsynchronized latest-frame-wins capture thread
// (utils/webcam_utils.py WebcamVideoStream:15-49, which tears: `update`
// writes self.frame while `read` returns it with no lock — SURVEY §5).
// Here writes are slot-atomic: the producer publishes a frame by bumping a
// monotonically increasing tick AFTER the copy completes; the consumer reads
// the newest fully-published frame and learns its tick (so dropped frames
// are observable).
//
// Exposed as a C ABI for ctypes binding.

#include <atomic>
#include <cstdint>
#include <cstring>

namespace {

struct Ring {
  int slots;
  size_t frame_bytes;
  uint8_t* data;
  std::atomic<uint64_t>* seq;   // per-slot publish tick (0 = empty)
  std::atomic<uint64_t> tick;   // global publish counter
};

}  // namespace

extern "C" {

void* ring_create(int slots, int frame_bytes) {
  Ring* r = new Ring();
  r->slots = slots;
  r->frame_bytes = static_cast<size_t>(frame_bytes);
  r->data = new uint8_t[static_cast<size_t>(slots) * frame_bytes];
  r->seq = new std::atomic<uint64_t>[slots];
  for (int i = 0; i < slots; ++i) r->seq[i].store(0);
  r->tick.store(0);
  return r;
}

void ring_destroy(void* handle) {
  Ring* r = static_cast<Ring*>(handle);
  delete[] r->data;
  delete[] r->seq;
  delete r;
}

//

// Producer: copy a frame in, then publish it with the next tick.
// Returns the tick assigned to this frame (>= 1).
uint64_t ring_push(void* handle, const uint8_t* frame) {
  Ring* r = static_cast<Ring*>(handle);
  uint64_t t = r->tick.load(std::memory_order_relaxed) + 1;
  int slot = static_cast<int>(t % r->slots);
  // mark slot as in-flight (seq 0) so a racing reader skips it
  r->seq[slot].store(0, std::memory_order_release);
  std::memcpy(r->data + static_cast<size_t>(slot) * r->frame_bytes, frame,
              r->frame_bytes);
  r->seq[slot].store(t, std::memory_order_release);
  r->tick.store(t, std::memory_order_release);
  return t;
}

// Consumer: copy out the newest fully-published frame.
// Returns its tick, or 0 if nothing has been published yet.
uint64_t ring_read_latest(void* handle, uint8_t* out) {
  Ring* r = static_cast<Ring*>(handle);
  for (int attempt = 0; attempt < 4; ++attempt) {
    uint64_t t = r->tick.load(std::memory_order_acquire);
    if (t == 0) return 0;
    int slot = static_cast<int>(t % r->slots);
    if (r->seq[slot].load(std::memory_order_acquire) != t) continue;
    std::memcpy(out, r->data + static_cast<size_t>(slot) * r->frame_bytes,
                r->frame_bytes);
    // validate the slot wasn't overwritten mid-copy
    if (r->seq[slot].load(std::memory_order_acquire) == t) return t;
  }
  return 0;
}

uint64_t ring_latest_tick(void* handle) {
  return static_cast<Ring*>(handle)->tick.load(std::memory_order_acquire);
}

}  // extern "C"
