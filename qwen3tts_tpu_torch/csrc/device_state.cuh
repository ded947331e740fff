// Host-side state that CUDA keeps per device: a kernel's dynamic shared
// memory limit and carveout (cudaFuncSetAttribute), and a device's
// attributes (its SM count, its opt-in shared memory per block). Each is
// kept here one entry a device index, for the device current on the calling
// thread when a launch is enqueued (the wrappers in ops/ make their
// operands' device current first). A value cached once per process would
// hold only for the first device: the first launch on a second device that
// needs more than 48 KB of dynamic shared memory would fail.
//
// Several host threads may launch at once (one a device of a data-parallel
// mesh), so the entries are atomics and the attribute updates run under one
// lock a translation unit.
#pragma once

#include <cuda_runtime.h>

#include <atomic>
#include <mutex>

namespace qt {
namespace {

constexpr int QT_MAX_DEVICES = 64;

// The calling thread's current device, or -1 if it is out of the tables'
// range (the launch then returns cudaErrorInvalidDevice).
inline int current_device() {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= QT_MAX_DEVICES) return -1;
  return dev;
}

inline std::mutex& attr_lock() {
  static std::mutex m;
  return m;
}

// A device attribute of the current device, read once a device.
template <cudaDeviceAttr ATTR>
inline int device_attr(int fallback) {
  static std::atomic<int> value[QT_MAX_DEVICES];
  const int dev = current_device();
  if (dev < 0) return fallback;
  int v = value[dev].load(std::memory_order_relaxed);
  if (v == 0) {
    if (cudaDeviceGetAttribute(&v, ATTR, dev) != cudaSuccess || v <= 0) v = fallback;
    value[dev].store(v, std::memory_order_relaxed);
  }
  return v;
}

// Raise ``kernel``'s dynamic shared memory limit on the current device to
// at least ``bytes``; ``allowed`` is that kernel's table of the limits set,
// one entry a device. With ``max_carveout`` the first call on a device also
// asks for the largest shared memory carveout.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes, std::atomic<size_t> (&allowed)[QT_MAX_DEVICES],
                              bool max_carveout = false) {
  const int dev = current_device();
  if (dev < 0) return cudaErrorInvalidDevice;
  if (bytes <= allowed[dev].load(std::memory_order_acquire)) return cudaSuccess;
  std::lock_guard<std::mutex> hold(attr_lock());
  const size_t was = allowed[dev].load(std::memory_order_relaxed);
  if (bytes <= was) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess && max_carveout && was == 0)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess) allowed[dev].store(bytes, std::memory_order_release);
  return e;
}

}  // namespace
}  // namespace qt
