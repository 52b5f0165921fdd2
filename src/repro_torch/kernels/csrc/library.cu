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
int repro_blas2_attrs(int kind, int tile, int dtype, int* regs, int* smem,
                      int* max_threads);
int repro_blas2_tile_info(int kind, int tile, int* out);
int repro_jacobi_attrs(int tile, int dtype, int* regs, int* smem,
                       int* max_threads);
int repro_jacobi_tile_info(int tile, int* out);

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
    case KIND_MATVEC: case KIND_ATAX: case KIND_BICG:
      return repro_blas2_attrs(kind, tile, dtype, regs, smem, max_threads);
    case KIND_JACOBI:
      return repro_jacobi_attrs(tile, dtype, regs, smem, max_threads);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Up to REPRO_TILE_INFO_INTS ints describing one tile (see the per-source
// tile_info); -1 when the index is past the table.
int repro_tile_info(int kind, int tile, int* out) {
  switch (kind) {
    case KIND_GEMM: case KIND_GATED: case KIND_STREAM:
      return repro_gemm_tile_info(kind, tile, out);
    case KIND_RMS:
      return repro_rms_tile_info(tile, out);
    case KIND_FLASH: case KIND_BLOCKED:
      return repro_attn_tile_info(kind, tile, out);
    case KIND_MATVEC: case KIND_ATAX: case KIND_BICG:
      return repro_blas2_tile_info(kind, tile, out);
    case KIND_JACOBI:
      return repro_jacobi_tile_info(tile, out);
    default:
      return -1;
  }
}

// Number of compiled tiles of one kind.
int repro_tile_count(int kind) {
  int out[REPRO_TILE_INFO_INTS];
  int n = 0;
  while (repro_tile_info(kind, n, out) == 0) ++n;
  return n;
}

}  // extern "C"

REPRO_EXPORT_ERROR_STRING
