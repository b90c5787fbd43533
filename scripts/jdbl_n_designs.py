#!/usr/bin/env python3
"""Times design alternatives of the Fq `jdbl_n` kernel (csrc/warp.cuh)
against this checkout's, in turns, on one card.

    python3 scripts/jdbl_n_designs.py [--rounds N]

Each design is a copy of this checkout's `crescent_tpu_torch/` under
`build/designs/<name>/` (gitignored) with one change to `csrc/warp.cuh`:

* `field_sums`: the sums and differences between the doubling's stages by
  field.cuh's `fe_add` / `fe_sub` (64-bit accumulators, the other kernels'
  sums) in place of warp.cuh's PTX carry chains `fe_add_cc` / `fe_sub_cc`;
* `thread_product`: each product of a stage computed whole by every thread
  of its group (`fe_mont_mul`, one thread a product, the stage split kept)
  in place of the group's 8-thread product, one word a thread.

The designs are built at once (one nvcc each), then
`scripts/time_chain_kernels.py --turns` checks every build bit-equal to the
plain versions and times `jdbl_n` (and `inv`, unchanged) at the window
combine's five shapes, this checkout and the designs in turns.

Needs a CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import os
import re
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(HERE, "build", "designs")

THREAD_PRODUCT = """template <int N>
__device__ __forceinline__ void warp_products(const Fe (&a)[N], const Fe (&b)[N],
                                              Fe (&out)[N], const Mod& M,
                                              int g, int k, uint32_t pk) {
  Fe x = a[0], y = b[0];
#pragma unroll
  for (int j = 1; j < N; ++j) {
    x = fe_select(g == j, a[j], x);
    y = fe_select(g == j, b[j], y);
  }
  const Fe r = fe_mont_mul(x, y, M);
#pragma unroll
  for (int j = 0; j < N; ++j) {
#pragma unroll
    for (int i = 0; i < 8; ++i) out[j].w[i] = __shfl_sync(kFullWarp, r.w[i], 8 * j);
  }
}
"""


def _replace_function(src: str, head: str, new: str) -> str:
    """`src` with the definition that starts with `head` (up to its closing
    brace in column 0) replaced by `new`."""
    a = src.index(head)
    b = src.index("\n}\n", a) + 3
    return src[:a] + new + src[b:]


def _field_sums(src: str) -> str:
    body = src[src.index("__device__ __forceinline__ PtT<Fe> warp_double("):]
    assert "fe_add_cc(" in body and "fe_sub_cc(" in body
    new = body.replace("fe_add_cc(", "fe_add(").replace("fe_sub_cc(", "fe_sub(")
    return src[:len(src) - len(body)] + new


def _thread_product(src: str) -> str:
    return _replace_function(src, "template <int N>\n__device__ __forceinline__ void warp_products(",
                             THREAD_PRODUCT)


DESIGNS = {"field_sums": _field_sums, "thread_product": _thread_product}


def make(name: str) -> str:
    """Copy the port into build/designs/<name>/ with the design's warp.cuh."""
    root = os.path.join(OUT, name)
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(os.path.join(HERE, "crescent_tpu_torch"),
                    os.path.join(root, "crescent_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    path = os.path.join(root, "crescent_tpu_torch", "csrc", "warp.cuh")
    with open(path) as f:
        src = f.read()
    new = DESIGNS[name](src)
    assert new != src, name
    with open(path, "w") as f:
        f.write(new)
    return root


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    roots = [make(name) for name in DESIGNS]
    build = "import sys; sys.path.insert(0, sys.argv[1]); " \
            "from crescent_tpu_torch.ops import _build; print(_build.build_all(['ec']).get('ec', ''))"
    procs = [subprocess.Popen([sys.executable, "-c", build, root], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for root in [HERE] + roots]
    for root, proc in zip([HERE] + roots, procs):
        out, _ = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"jdbl_n_designs: the build in {root} failed:\n{out}")
        lines = out.splitlines()
        for i, line in enumerate(lines):  # the warp kernels' registers and spills
            if "Compiling entry" in line and "warp_jdbl_n" in line:
                info = " ".join(lines[i + 1:i + 4])
                regs = re.search(r"Used (\d+) registers", info)
                spill = re.search(r"(\d+) bytes spill stores", info)
                print(os.path.relpath(root, HERE), line.split("'")[1], "|",
                      f"{regs and regs.group(1)} registers, {spill and spill.group(1)} bytes "
                      "spill stores", flush=True)
    res = subprocess.run([sys.executable, os.path.join(HERE, "scripts", "time_chain_kernels.py"),
                          "--turns", *roots, "--rounds", str(args.rounds)])
    sys.exit(res.returncode)


if __name__ == "__main__":
    main()
