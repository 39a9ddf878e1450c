// K4 head_rowsums: the serving entry point of the fused output head
// (device code and its notes in head_rowsums.cuh).

#include "head_rowsums.cuh"

LD_API int ld_head_rowsums(const void* t, const void* w, const void* bias,
                           const void* xs, void* S, int B, int H, int W,
                           int cin, int C, int zero_rows, int act,
                           void* stream) {
  return ldhead::launch_head_rowsums<bf16, false>(
      t, w, bias, xs, S, B, H, W, cin, C, zero_rows, act, stream);
}
