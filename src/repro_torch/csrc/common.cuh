// Shared declarations of the port's CUDA kernels.
//
// Every kernel is exported through a plain C entry (loaded with ctypes):
// pointers and the stream arrive as void*, sizes as long long, and each
// entry returns cudaGetLastError() right after its launch so the Python
// wrapper can raise on a launch the runtime refused.  Packed binary words
// are 32-bit, LSB-first, with zero pad bits; the host sees them as int32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define COBRA_API extern "C" __attribute__((visibility("default")))

static inline int cobra_launch_status() {
  return static_cast<int>(cudaGetLastError());
}
