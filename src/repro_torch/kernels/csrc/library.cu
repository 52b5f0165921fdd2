// The library-wide part of the C interface: compiled-kernel attributes,
// tile tables and error strings, dispatched by kernel kind to the
// per-source functions.
#include "common.cuh"

extern "C" {

int repro_gemm_attrs(int kind, int tile, int dtype, int* regs, int* smem,
                     int* max_threads);
int repro_gemm_tile_info(int kind, int tile, int* out);
int repro_rms_attrs(int tile, int dtype, int* regs, int* smem,
                    int* max_threads);
int repro_rms_tile_info(int tile, int* out);
int repro_attn_attrs(int kind, int tile, int dtype, int* regs, int* smem,
                     int* max_threads);
int repro_attn_tile_info(int kind, int tile, int* out);

// numRegs / static shared bytes / max threads of one compiled
// instantiation (cudaFuncGetAttributes), for checking the analysis'
// declared register estimates against the binary.
int repro_kernel_attrs(int kind, int tile, int dtype, int* regs, int* smem,
                       int* max_threads) {
  switch (kind) {
    case KIND_GEMM: case KIND_GATED: case KIND_STREAM:
      return repro_gemm_attrs(kind, tile, dtype, regs, smem, max_threads);
    case KIND_RMS:
      return repro_rms_attrs(tile, dtype, regs, smem, max_threads);
    case KIND_FLASH: case KIND_BLOCKED:
      return repro_attn_attrs(kind, tile, dtype, regs, smem, max_threads);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Six ints describing one tile (see the per-source tile_info); -1 when
// the index is past the table.
int repro_tile_info(int kind, int tile, int* out) {
  switch (kind) {
    case KIND_GEMM: case KIND_GATED: case KIND_STREAM:
      return repro_gemm_tile_info(kind, tile, out);
    case KIND_RMS:
      return repro_rms_tile_info(tile, out);
    case KIND_FLASH: case KIND_BLOCKED:
      return repro_attn_tile_info(kind, tile, out);
    default:
      return -1;
  }
}

// Number of compiled tiles of one kind.
int repro_tile_count(int kind) {
  int out[6];
  int n = 0;
  while (repro_tile_info(kind, n, out) == 0) ++n;
  return n;
}

const char* repro_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
