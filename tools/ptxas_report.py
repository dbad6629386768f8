#!/usr/bin/env python3
"""Print what ptxas reports for each kernel of one CUDA source of the port:
registers, shared and constant bytes, and spills.

    python3 tools/ptxas_report.py [bsr_spmm_panel]

Compiles ``rbl_tpu_torch/csrc/<stem>.cu`` with the flags the package builds
it with, plus ``-Xptxas -v``, into a temporary directory (the package's own
build is left alone), and prints ptxas's lines, kernel names demangled
where ``cu++filt`` is on the path.  Needs ``nvcc``.
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def report(stem: str) -> list[str]:
    from rbl_tpu_torch.ops.spmm import _kernels

    src = os.path.join(ROOT, "rbl_tpu_torch", "csrc", f"{stem}.cu")
    with tempfile.TemporaryDirectory() as tmp:
        out = subprocess.run(
            [_kernels._nvcc(), *_kernels._NVCC_FLAGS, "-Xptxas", "-v",
             "-o", os.path.join(tmp, f"lib{stem}.so"), src],
            capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{out.stdout}{out.stderr}")
    lines = [ln.strip() for ln in (out.stdout + out.stderr).splitlines()
             if "ptxas info" in ln or "spill" in ln]
    demangle = shutil.which("cu++filt") or shutil.which("c++filt")
    if demangle:
        names = sorted(set(re.findall(r"_Z\w+", "\n".join(lines))))
        if names:
            plain = subprocess.run([demangle, *names], capture_output=True,
                                   text=True).stdout.splitlines()
            for a, b in zip(names, plain):
                lines = [ln.replace(a, b) for ln in lines]
    return lines


def main(argv=None) -> int:
    stems = (argv if argv is not None else sys.argv[1:]) or ["bsr_spmm_panel"]
    for stem in stems:
        print(f"== {stem}.cu")
        for ln in report(stem):
            print(ln)
    return 0


if __name__ == "__main__":
    sys.exit(main())
