"""Compare the machine code of the NB1D row-tile kernels of two checkouts.

Each kernel that runs `csrc/nb1d.cuh`'s row tile is built twice since the
tile splits rows wider than itself: with kSeg = false (whole rows, every
shape up to 512 columns) and kSeg = true (segments). The whole rows' build
is meant to stay the code it was before segments existed. This tool builds
`encoder_fused.cu`, `decoder_fused.cu`, `nb1d_chain.cu` and `nb1d.cu` of
both checkouts to cubins with the flags of `ops/_build.py`, prints ptxas's
register, stack and spill lines for every kernel, and for each whole-row
kernel of the second checkout says whether its SASS (cuobjdump, addresses
and encodings dropped) equals that of the first checkout's kernel of the
same role, with the count of instructions that differ. It needs the CUDA
toolkit (nvcc, cuobjdump, c++filt), not a card, and runs no kernel.

    python -m lanedetection_end2end_tpu_torch.tools.sass_diff OLD NEW [OUT]

OLD and NEW: roots of two checkouts of the repo; OUT (default: a temporary
directory) keeps the cubins and, for each kernel that differs, both
instruction lists.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys
import tempfile

from lanedetection_end2end_tpu_torch.ops._build import NVCC_FLAGS, _nvcc

SOURCES = ("encoder_fused", "decoder_fused", "nb1d_chain", "nb1d")


def _demangle(names):
    out = subprocess.run(["c++filt"], input="\n".join(names),
                         capture_output=True, text=True).stdout
    return out.splitlines()


def build(root: str, out: str, tag: str):
    """{kernel: [instruction, ...]} of the checkout at `root`, printing
    ptxas's lines for each kernel."""
    nvcc = _nvcc()
    flags = [f for f in NVCC_FLAGS if f not in ("-shared", "-Xcompiler",
                                                "-fPIC")]
    procs = {}
    for name in SOURCES:
        cubin = os.path.join(out, f"{tag}_{name}.cubin")
        src = os.path.join(root, "lanedetection_end2end_tpu_torch", "csrc",
                           f"{name}.cu")
        procs[name] = (subprocess.Popen(
            [nvcc, *flags, "-cubin", "-o", cubin, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            cubin)
    sass = {}
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    for name, (proc, cubin) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {tag} {name}:\n{log}")
        kernel = None
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                kernel = _short(_demangle([m.group(1)])[0])
            elif kernel and ("registers" in line or "spill" in line):
                print(f"{tag} {kernel}: {line.split(':', 1)[-1].strip()}")
        text = subprocess.run([cuobjdump, "-sass", cubin],
                              capture_output=True, text=True).stdout
        current = None
        for line in text.splitlines():
            m = re.match(r"\s*Function : (\S+)", line)
            if m:
                current = _short(_demangle([m.group(1)])[0])
                sass[current] = []
                continue
            m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s*(.*?)\s*;", line)
            if current and m:
                sass[current].append(m.group(1))
    return sass


def _short(name: str) -> str:
    """`ns::kernel<args>` without the return type and parameter list."""
    name = re.sub(r"^void ", "", name)
    return name.removeprefix("(anonymous namespace)::").split("(")[0]


def role(name: str) -> str:
    """The name the kernel had before it took kSeg: `k<C, false>` -> `k<C>`,
    `k<false>` -> `k`."""
    return re.sub(r"<false>$", "", re.sub(r", false>", ">", name))


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    if len(args) not in (2, 3):
        print(__doc__)
        return 2
    out = args[2] if len(args) == 3 else tempfile.mkdtemp()
    os.makedirs(out, exist_ok=True)
    old, new = build(args[0], out, "old"), build(args[1], out, "new")
    for name in sorted(new):
        if "true>" in name:
            continue
        ref = old.get(role(name))
        if ref is None:
            print(f"SASS {name}: no kernel of its role in OLD")
            continue
        got = new[name]
        differ = (sum(a != b for a, b in zip(ref, got))
                  + abs(len(ref) - len(got)))
        print(f"SASS {name} vs {role(name)}: "
              f"{'identical' if ref == got else 'differs'} ({len(ref)} / "
              f"{len(got)} instructions, {differ} differ)")
        if ref != got:
            stem = re.sub(r"[^A-Za-z0-9]+", "_", name)
            for tag, ins in (("old", ref), ("new", got)):
                with open(os.path.join(out, f"{tag}_{stem}.sass"), "w") as f:
                    f.write("\n".join(ins) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
