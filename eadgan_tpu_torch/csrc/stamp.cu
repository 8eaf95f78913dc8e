// The device clock written into a buffer: the phase stamps of a traced
// replayed train step (train/chain.py).
//
// Replaces no TPU kernel: instrumentation added with the port's tracing
// (utils/trace.py).  One thread reads %globaltimer, the card's nanosecond
// clock, and writes it to slot `index` of an int64 buffer.  Launched on
// the step's stream, it runs after the kernel before it has finished and
// before the one after it starts, so two stamps bound the device time of
// the work between them, gaps included.  Bound: one launch (~2 us in a
// graph); it moves 8 bytes.

#include <cuda_runtime.h>
#include <cstdint>

__global__ void stamp_kernel(long long* slots, int index) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  slots[index] = static_cast<long long>(t);
}

extern "C" int eadgan_stamp(void* slots, int index, void* stream) {
  stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(static_cast<long long*>(slots), index);
  return static_cast<int>(cudaGetLastError());
}
