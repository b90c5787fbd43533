#!/usr/bin/env python3
"""Where Groth16 setup's device branch spends its time on the card.

    python3 scripts/profile_setup.py [log2_size]

Builds the CUDA kernels and the native backend, makes dummy_circuit(log2_size)
(default 21: domain 2^21, the reference's proof-benchmark circuit) and runs
``setup(..., device="cuda")`` three times from one seed: the first warms the
allocator and loads the kernel libraries, the second is timed by phase
(``setup(timings=)``), the third runs under ``torch.profiler``.  The keys
must be equal.  Prints the split by phase, the device's busy time by kernel
group (busy time only; copies included), each fixed-base batch's window
kernel (``fixed_base``: its device time beside its bound, counted in the
first run from the batch's scalars by chip_smoke.py's ``fixed_base_adds``
and ``fixed_base_bound``, the kernels line's yardstick), and the idle share
of the timed run: 1 - busy / wall.

Needs a CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import os
import random
import subprocess
import sys
import time
from collections import defaultdict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import fixed_base_adds, fixed_base_bound  # noqa: E402

GROUPS = (  # (substring of the kernel's name, group); the first match wins
    ("fq2_mul_kernel", "port kernel fq2 mul"),
    ("fq2_inv_kernel", "port kernel fq2 inv"),
    ("mul_kernel", "port kernel mul"),
    ("inv_kernel", "port kernel inv"),
)


def _group(name: str) -> str:
    for kernel in ("fixed_base_kernel", "madd_kernel"):  # templates over Fe (Fq) or Fe2
        if kernel in name:
            op = kernel[:-len("_kernel")]
            return f"port kernel fq2 {op}" if "Fe2" in name else f"port kernel {op}"
    for key, label in GROUPS:
        if key in name:
            return label
    low = name.lower()
    if "index" in low or "gather" in low:
        return "row gathers (index_select)"
    if "memcpy" in low or "memset" in low:
        return "memcpy / memset (uploads, downloads)"
    return "elementwise and other PyTorch kernels"


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        sys.exit("profile_setup: needs a CUDA card")
    from crescent_tpu_torch.models import groth16
    from crescent_tpu_torch.ops import _build

    logn = int(sys.argv[1]) if len(sys.argv) > 1 else 21
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip(), flush=True)
    _build.build_all()
    t0 = time.perf_counter()
    r1cs, _ = groth16.dummy_circuit(logn, random.Random(1))
    print(f"dummy_circuit({logn}): {r1cs.num_vars} vars, {time.perf_counter() - t0:.3f} s",
          flush=True)

    def run(timings=None):
        pk = groth16.setup(r1cs, random.Random(2), device="cuda", timings=timings)
        torch.cuda.synchronize()
        return pk

    from crescent_tpu_torch.ops import cuda_ec

    batches = []
    kernel = getattr(cuda_ec._Kernels, "fixed_base", None)  # None: a checkout before it

    def counted(ec, table, sc):
        """The batch's bound, from its digits (this run only: it waits)."""
        adds = fixed_base_adds(torch, sc)
        batches.append((ec.WIDTH, sc.shape[0], adds,
                        fixed_base_bound(sc.shape[0], ec.WIDTH, adds)[0]))
        return kernel(ec, table, sc)

    if kernel:
        cuda_ec._Kernels.fixed_base = counted
    t0 = time.perf_counter()
    try:
        first = run()
    finally:
        if kernel:
            cuda_ec._Kernels.fixed_base = kernel
    print(f"setup, first: {time.perf_counter() - t0:.3f} s", flush=True)
    for w, n, adds, bound_ms in batches:
        print(f"fixed-base batch over {'Fq2' if w == 16 else 'Fq'}: {n} lanes, {adds} "
              f"additions, bound {bound_ms:.3f} ms", flush=True)
    timings: dict = {}
    t0 = time.perf_counter()
    pk = run(timings)
    wall = time.perf_counter() - t0
    print(f"setup, timed: {wall:.3f} s; "
          + ", ".join(f"{k} {v:.3f} s" for k, v in timings.items()), flush=True)
    assert pk.a_query == first.a_query and pk.b_g2_query == first.b_g2_query

    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
    prof_wall = time.perf_counter() - t0
    groups = defaultdict(lambda: [0.0, 0])
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", 0) or getattr(ev, "self_cuda_time_total", 0)
        if not dev_us or "cuda" not in str(getattr(ev, "device_type", "cuda")).lower():
            continue
        rows.append((dev_us, ev.count, ev.key))
        g = groups[_group(ev.key)]
        g[0] += dev_us
        g[1] += ev.count
    busy = sum(v[0] for v in groups.values()) / 1e6
    if not busy:
        print("torch.profiler reported no device time on this machine")
        return
    print(f"device busy time by kernel group (torch.profiler, one setup of "
          f"{prof_wall:.3f} s under the profiler): {busy * 1e3:.3f} ms")
    for g, (us, cnt) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        print(f"  {g:40s} {us / 1e3:9.3f} ms  {100 * us / 1e6 / busy:5.1f}%  {cnt:6d} launches")
    for us, cnt, name in rows:
        if "fixed_base_kernel" in name:
            print(f"window kernel {name[:60]}: {us / 1e3:.3f} ms in {cnt} launches")
    print("top 10 kernels:")
    for us, cnt, name in sorted(rows, reverse=True)[:10]:
        print(f"  {us / 1e3:9.3f} ms  {cnt:5d}x  {name[:110]}")
    print(f"idle share of the timed setup: {1 - busy / wall:.3f} "
          f"(1 - {busy:.3f} s busy / {wall:.3f} s)")


if __name__ == "__main__":
    main()
