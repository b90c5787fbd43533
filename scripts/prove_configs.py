#!/usr/bin/env python3
"""Groth16 prove on the card in its three device configurations, in turns.

    python3 scripts/prove_configs.py [log2_size] [rounds]

Builds the CUDA kernels and the native backend, makes dummy_circuit(log2_size)
(default 21: the reference's proof-benchmark circuit) and sets it up on the
card.  Then, after one warm prove of each, runs `rounds` (default 6)
rounds of proves with fixed r and s, the order reversed every other round:

* default: h(x) and the G1 fold on the card, the G2 MSM on the native host
  backend on a worker thread beside the fold;
* CRESCENT_NATIVE=0: the G2 MSM on the card too, enqueued behind the fold;
* CRESCENT_MSM_FUSED_AGG=1 CRESCENT_NATIVE=0: the same, each chunk's suffix
  sums and bucket weighting in one ``bucket_reduce`` launch.

The proofs must be equal.  Prints every prove's total and MSM phases, the
median and quartiles of each configuration, and, for one prove of each under
``torch.profiler``, the device's busy time by kernel group and the idle share
(1 - busy / the configuration's median wall time).

Needs a CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import os
import random
import statistics
import subprocess
import sys
import time
from collections import defaultdict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CONFIGS = {"default": {}, "CRESCENT_NATIVE=0": {"CRESCENT_NATIVE": "0"},
           "fused, CRESCENT_NATIVE=0": {"CRESCENT_MSM_FUSED_AGG": "1",
                                        "CRESCENT_NATIVE": "0"}}
# the first name a kernel's contains names its group (batch_inv before inv)
PORT_KERNELS = ("bucket_reduce", "affine_denom", "affine_add", "jadd", "jdbl_n", "jdbl",
                "madd", "mul", "batch_inv", "inv", "butterfly")


def _group(name: str) -> str:
    for k in PORT_KERNELS:
        if f"{k}_kernel" in name or f"{k}_halves_kernel" in name:  # halves: Fq2's
            fq2 = "Fe2" in name or "fq2_" in name or "_halves_" in name
            return f"port kernel {k}" + (" (Fq2)" if fq2 else "")
    low = name.lower()
    if "sort" in low or "radix" in low:
        return "sort kernels"
    if "index" in low or "gather" in low or "scatter" in low:
        return "gather / scatter kernels"
    if "memcpy" in low or "memset" in low:
        return "memcpy / memset"
    return "elementwise and other PyTorch kernels"


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        sys.exit("prove_configs: needs a CUDA card")
    from crescent_tpu_torch.models import groth16
    from crescent_tpu_torch.ops import _build

    logn = int(sys.argv[1]) if len(sys.argv) > 1 else 21
    rounds = int(sys.argv[2]) if len(sys.argv) > 2 else 6
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip(), flush=True)
    _build.build_all()
    r1cs, z = groth16.dummy_circuit(logn, random.Random(1))
    pk = groth16.setup(r1cs, random.Random(2), device="cuda")
    print(f"dummy_circuit({logn}): {r1cs.num_vars} vars, set up on the card", flush=True)

    def prove(cfg: str, timings=None):
        env = CONFIGS[cfg]
        old = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            proof = groth16.prove(pk, r1cs, z, random.Random(0), r=0x1234567, s=0x7654321,
                                  device="cuda", timings=timings)
            torch.cuda.synchronize()
        finally:
            for k, v in old.items():
                if v is None:
                    os.environ.pop(k)
                else:
                    os.environ[k] = v
        return proof

    want = prove("default")  # warm: tables on the card, libraries loaded
    for cfg in list(CONFIGS)[1:]:
        assert prove(cfg) == want, "the configurations' proofs differ"
    walls = {cfg: [] for cfg in CONFIGS}
    for i in range(rounds):
        for cfg in (list(CONFIGS) if i % 2 == 0 else list(CONFIGS)[::-1]):
            timings: dict = {}
            t0 = time.perf_counter()
            assert prove(cfg, timings) == want, "the configurations' proofs differ"
            wall = time.perf_counter() - t0
            walls[cfg].append(wall)
            print(f"round {i} {cfg}: total {wall:.3f} s; "
                  + ", ".join(f"{k} {v:.3f} s" for k, v in timings.items()), flush=True)
    for cfg, w in walls.items():
        q1, med, q3 = statistics.quantiles(w, n=4) if len(w) > 1 else (w[0],) * 3
        print(f"{cfg}: median {med:.3f} s, quartiles {q1:.3f} / {q3:.3f} s over {len(w)} proves")

    from torch.profiler import ProfilerActivity, profile

    for cfg in CONFIGS:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            prove(cfg)
        groups = defaultdict(lambda: [0.0, 0])
        for ev in prof.key_averages():
            dev_us = (getattr(ev, "self_device_time_total", 0)
                      or getattr(ev, "self_cuda_time_total", 0))
            if not dev_us or "cuda" not in str(getattr(ev, "device_type", "cuda")).lower():
                continue
            g = groups[_group(ev.key)]
            g[0] += dev_us
            g[1] += ev.count
        busy = sum(v[0] for v in groups.values()) / 1e6
        if not busy:
            print("torch.profiler reported no device time on this machine")
            return
        wall = statistics.median(walls[cfg])
        print(f"{cfg}: device busy {busy:.3f} s in one prove under torch.profiler; idle "
              f"share {1 - busy / wall:.3f} (1 - busy / median wall {wall:.3f} s)")
        for g, (us, cnt) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
            print(f"  {g:40s} {us / 1e3:9.3f} ms  {100 * us / 1e6 / busy:5.1f}%  {cnt:6d} launches")


if __name__ == "__main__":
    main()
