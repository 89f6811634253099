// Shared helpers for the port's CUDA sources.  Each source builds into its
// own shared library with a plain C interface (loaded through ctypes by
// ddl_tpu_torch/ops/_build.py), so every library exports its own copy of
// ddl_error_string.
#pragma once

#include <cuda_runtime.h>

extern "C" const char* ddl_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
