// Shared by every kernel library of the port: each .cu builds into its own
// shared library with a plain C interface (see _build.py), and each exports
// wft_error_string so the Python wrapper can name a failed launch.
#pragma once

#include <cuda_runtime.h>

extern "C" const char* wft_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
