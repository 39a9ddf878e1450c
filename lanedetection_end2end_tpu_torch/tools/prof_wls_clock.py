"""The phases of K12's two-pass design, counted with clock64.

K12 `wls_moments` was first a two-pass design (`wls_partial_kernel`: a
CTA a 512-pixel chunk, four 128-pixel tiles each loaded by every thread
with 4-byte loads, then multiplied, a barrier between; `wls_sum_kernel`:
one thread per output adding the chunks in order). This tool copies a
checkout's `csrc/wls_moments.cu` of that design, adds clock64 counters
around each tile's loading (loads and barriers) and multiplying and
around the final fold of the warps' sums, builds it with nvcc into a
program of its own under a temporary directory, and runs it on the card
at the engine's shape (B 8, N 131,072, C 4, K 20, zero inputs): cycles a
CTA in each phase, averaged over REPS calls, the ms a call back to back
(CUDA events) and `wls_sum_kernel`'s alone.

    python lanedetection_end2end_tpu_torch/tools/prof_wls_clock.py --root DIR

DIR: a checkout whose K12 has that design; the tool refuses any other
source. Needs nvcc and a card.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile

# (anchor in the two-pass source, what the instrumented copy puts there)
PATCHES = (
    ("namespace {\n",
     "namespace {\n__device__ unsigned long long g_clk[4];\n"),
    ("""  for (int n0 = n_begin; n0 < n_end; n0 += TILE) {
    const int cnt = min(TILE, n_end - n0);
    __syncthreads();  // the previous tile has been read""",
     """  long long t_load = 0, t_fma = 0, t0 = clock64();
  for (int n0 = n_begin; n0 < n_end; n0 += TILE) {
    const int cnt = min(TILE, n_end - n0);
    __syncthreads();  // the previous tile has been read
    long long ta = clock64();"""),
    ("""    __syncthreads();
    const float* wrow = sW + lb * pitch + c;""",
     """    __syncthreads();
    long long tb = clock64(); t_load += tb - ta;
    const float* wrow = sW + lb * pitch + c;"""),
    ("""        acc[4 * j + 3] += w2 * q.w;
      }
    }
  }
""", """        acc[4 * j + 3] += w2 * q.w;
      }
    }
    t_fma += clock64() - tb;
  }
  long long tr = clock64();
"""),
    ("""    partial[((size_t)blockIdx.x * R + r) * K + k] = s;
  }
}""", """    partial[((size_t)blockIdx.x * R + r) * K + k] = s;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    long long te = clock64();
    atomicAdd(&g_clk[0], (unsigned long long)t_load);
    atomicAdd(&g_clk[1], (unsigned long long)t_fma);
    atomicAdd(&g_clk[2], (unsigned long long)(te - tr));
    atomicAdd(&g_clk[3], (unsigned long long)(te - t0));
  }
}"""),
)

MAIN = r"""
#include <cstdio>
int main() {
  const int B = 8, N = 131072, C = 4, K = 20, CH = 512, REPS = 20;
  const int chunks = (N + CH - 1) / CH;
  float *w, *b, *p, *o;
  cudaMalloc(&w, (size_t)B * N * C * 4);
  cudaMalloc(&b, (size_t)N * K * 4);
  cudaMalloc(&p, (size_t)chunks * B * C * K * 4);
  cudaMalloc(&o, B * C * K * 4);
  cudaMemset(w, 0, (size_t)B * N * C * 4);
  cudaMemset(b, 0, (size_t)N * K * 4);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  for (int i = 0; i < 5; ++i)
    ld_wls_moments(w, b, p, o, B, N, C, K, chunks, 0);
  unsigned long long z[4] = {0, 0, 0, 0}, c[4];
  cudaMemcpyToSymbol(g_clk, z, sizeof z);
  cudaEventRecord(e0);
  for (int i = 0; i < REPS; ++i)
    ld_wls_moments(w, b, p, o, B, N, C, K, chunks, 0);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms, sum_ms;
  cudaEventElapsedTime(&ms, e0, e1);
  cudaMemcpyFromSymbol(c, g_clk, sizeof c);
  const int RK = B * C * K;
  cudaEventRecord(e0);
  for (int i = 0; i < REPS; ++i)
    wls_sum_kernel<<<grid_1d(RK, 256), 256>>>(p, o, chunks, RK);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  cudaEventElapsedTime(&sum_ms, e0, e1);
  const double n = (double)REPS * chunks;
  printf("two-pass K12, %d CTAs: %.4f ms a call back to back, "
         "wls_sum_kernel alone %.4f ms; cycles a CTA: loading %.0f, "
         "multiplying %.0f, folding %.0f, whole %.0f\n",
         chunks, ms / REPS, sum_ms / REPS, c[0] / n, c[1] / n, c[2] / n,
         c[3] / n);
  return cudaGetLastError() != cudaSuccess;
}
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True,
                    help="a checkout whose K12 is the two-pass design")
    a = ap.parse_args(argv)
    csrc = os.path.join(os.path.abspath(a.root),
                        "lanedetection_end2end_tpu_torch", "csrc")
    src = open(os.path.join(csrc, "wls_moments.cu")).read()
    for anchor, patched in PATCHES:
        if src.count(anchor) != 1:
            print("prof_wls_clock: the source is not the two-pass K12 "
                  "design", file=sys.stderr)
            return 1
        src = src.replace(anchor, patched)
    out = tempfile.mkdtemp(prefix="prof_wls_clock_")
    cu, exe = os.path.join(out, "wls_clock.cu"), os.path.join(out, "wls_clock")
    with open(cu, "w") as f:
        f.write(src + MAIN)
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    subprocess.run([os.path.join(cuda_home, "bin", "nvcc"), "-gencode",
                    "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                    "-I", csrc, "-o", exe, cu], check=True)
    return subprocess.run([exe]).returncode


if __name__ == "__main__":
    raise SystemExit(main())
