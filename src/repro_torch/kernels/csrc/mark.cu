// Device marks of the port's tracing (repro_torch/tracing.py).
//
// One thread reads the card's %globaltimer (ns), takes the next slot of a
// ring by atomicAdd on the ring's head and writes (phase id, time) there.
// Past the ring's end it writes nothing; the head keeps counting, so the
// host reads the drops as head - capacity.  Launched in stream order between
// the kernels of a phase, it stamps the time at which the work before it
// ended; captured into a CUDA graph it takes a fresh slot on every replay.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

__global__ void mark_kernel(long long* slots, unsigned long long* head,
                            long long capacity, int phase) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  const unsigned long long slot = atomicAdd(head, 1ULL);
  if (slot < (unsigned long long)capacity) {
    slots[2 * slot] = phase;
    slots[2 * slot + 1] = (long long)t;
  }
}

}  // namespace

// slots (capacity, 2) int64 and head (1,) int64, on one device.  Launches on
// `stream` and returns the launch's cudaError_t.
extern "C" int repro_torch_mark(void* slots, void* head, long long capacity,
                                int phase, void* stream) {
  if (capacity < 1) return (int)cudaErrorInvalidValue;
  mark_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      static_cast<long long*>(slots), static_cast<unsigned long long*>(head),
      capacity, phase);
  return (int)cudaGetLastError();
}
