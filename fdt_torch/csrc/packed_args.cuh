// The C entries that a wrapper calls once a layer (K4, K5) take their
// arguments packed in one buffer of 64-bit fields, in the order of the
// struct the entry names: ctypes converts one pointer in about a
// microsecond, thirty numbers in about ten.  Each entry launches on the
// device its tensors are on and restores the caller's current device.
#pragma once
#include <cuda_runtime.h>
#include <string.h>

namespace {

template <typename T>
T read_args(const void* packed) {
  T a;
  memcpy(&a, packed, sizeof(T));
  return a;
}

template <typename F>
int on_device(long long device, F&& launch) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  if (prev != device && (err = cudaSetDevice((int)device)) != cudaSuccess) return (int)err;
  const int result = launch();
  if (prev != device) cudaSetDevice(prev);
  return result;
}

}  // namespace
