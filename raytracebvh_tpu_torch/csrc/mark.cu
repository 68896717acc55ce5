// Span marks: the device side of utils/profiling.py's spans.
//
// A span of the program (the frame, the build, a walk, a chunk of the
// chunk loop) is two marks, its begin and its end.  A mark is a one-thread
// kernel: it reads the card's %globaltimer (nanoseconds, the same clock on
// every SM) and appends one record to a record buffer in device memory,
// taking its slot with an atomic.  Launched while a stream captures a CUDA
// graph, the mark is a kernel node of the graph, and each replay records
// again; inside a WHILE node's body it records once a trip, the trip
// number read on the device from the loop's counter.  Nothing is read back
// to the host: the host copies the buffer out when it asks for the
// records.
//
// The buffer is int64: a header of four words, then `capacity` records of
// four words each.
//   header: [0] the next slot (every mark takes one, also past the end),
//           [1] the marks that found no slot (counted, not written),
//           [2] the current call's id (rtbvh_mark_call sets it before a
//               replay; the marks of the replay copy it),
//           [3] the capacity in records.
//   record: the call's id, the span's code (2 * span id + 1 for an end,
//           + 0 for a begin), the trip (the loop counter where one was
//           given, else the index the caller gave, -1 for none),
//           %globaltimer in ns.
// A mark replaces no TPU kernel: the JAX package has no spans inside its
// compiled programs.  Its cost is one launch or one graph node, a few
// microseconds at most, and it moves 32 bytes.  Its kernel's name begins
// rtbvh_mark, so a torch.profiler trace shows each boundary too.

#include <cuda_runtime.h>

namespace {

__global__ void rtbvh_mark_kernel(long long* buf, int code,
                                  const int* trip, int index) {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  unsigned long long* head = reinterpret_cast<unsigned long long*>(buf);
  unsigned long long slot = atomicAdd(head, 1ull);
  if (slot >= static_cast<unsigned long long>(buf[3])) {
    atomicAdd(head + 1, 1ull);
    return;
  }
  long long* rec = buf + 4 + 4 * slot;
  rec[0] = buf[2];
  rec[1] = code;
  rec[2] = trip != nullptr ? static_cast<long long>(*trip) : index;
  rec[3] = static_cast<long long>(now);
}

__global__ void rtbvh_mark_call_kernel(long long* buf, long long call) {
  buf[2] = call;
}

}  // namespace

// One mark into `buf` on `stream`: `trip` (an int32 in device memory) or,
// where it is null, `index` is the record's trip.
extern "C" int rtbvh_mark(void* buf, int code, const void* trip, int index,
                          void* stream) {
  rtbvh_mark_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(buf), code, static_cast<const int*>(trip),
      index);
  return cudaGetLastError();
}

// The id that the marks after it on `stream` copy into their records.
extern "C" int rtbvh_mark_call(void* buf, long long call, void* stream) {
  rtbvh_mark_call_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(buf), call);
  return cudaGetLastError();
}
