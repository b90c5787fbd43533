#!/usr/bin/env python3
"""Groth16 prove of this checkout against another tree's, in alternating
pairs, on one card.

    python3 scripts/prove_pairs.py OTHER_ROOT [--log2 21] [--pairs 10]
        [--configs default CRESCENT_NATIVE=0 fused verify] [--device cuda]

Starts one worker process a tree (this checkout and OTHER_ROOT, for example
the parent commit unpacked under the gitignored `build/`).  Each builds its
kernels, makes dummy_circuit(log2) from the same seeds, sets it up on the
card and proves once in each configuration to warm up; then it proves on
request, with fixed r and s.  The driver asks for `pairs` pairs in each
configuration (by default all three: default; CRESCENT_NATIVE=0, G2 on the
card too; and `fused`, CRESCENT_MSM_FUSED_AGG=1 with CRESCENT_NATIVE=0, each
chunk's aggregate one `bucket_reduce` launch; and on request `verify`,
CRESCENT_NATIVE=0's verify of the proof with the public-input MSM on the
card, its MSM's enqueue timed apart), the tree that goes first
alternating from pair to pair, and checks that every
proof of both trees is the same and that every verify accepts.  It prints every prove's wall time, each
tree's median and quartiles, the median of the pairs' differences (this -
other) and in how many pairs this checkout was the faster, and the same
medians for each phase of prove's `timings`.

Needs a CUDA card (`--device cpu --configs default` checks the script
itself at a small log2 on a machine without one); imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = {"default": {}, "CRESCENT_NATIVE=0": {"CRESCENT_NATIVE": "0"},
           # the fused aggregate: one bucket_reduce launch a chunk, G2 on the card
           "fused": {"CRESCENT_NATIVE": "0", "CRESCENT_MSM_FUSED_AGG": "1"},
           # not a prove: verify of the proof with the public-input MSM on the
           # card (the small-N path: 256 jdbl and 256 jadd launches a bit)
           "verify": {"CRESCENT_NATIVE": "0"}}
PROVES = ("default", "CRESCENT_NATIVE=0", "fused")


def worker(root: str, logn: int, device: str, configs: list[str]) -> None:
    """Set up dummy_circuit(logn) with the port in `root`, then answer one
    line a configuration name with one JSON line: wall seconds and proof."""
    sys.path.insert(0, root)
    import random

    import torch
    from crescent_tpu_torch.models import groth16
    from crescent_tpu_torch.ops import _build

    if device == "cuda":
        _build.build_all()
    r1cs, z = groth16.dummy_circuit(logn, random.Random(1))
    pk = groth16.setup(r1cs, random.Random(2), device=device)

    made = {}

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    def prove() -> dict:
        timings: dict = {}
        t0 = time.perf_counter()
        pr = groth16.prove(pk, r1cs, z, random.Random(0), r=0x1234567, s=0x7654321,
                           device=device, timings=timings)
        sync()
        wall = time.perf_counter() - t0
        made["proof"] = pr
        b = pr.b
        proof = repr((tuple(pr.a), (b[0].c0, b[0].c1, b[1].c0, b[1].c1), tuple(pr.c)))
        return {"wall": wall, "proof": proof, "timings": timings}

    def verify() -> dict:
        """verify (the public-input MSM on `device`, read back), then the
        same MSM's run_device alone: its enqueue (host time to return) and
        its time to the device's end."""
        from crescent_tpu_torch.core.curves import BN254_G1
        from crescent_tpu_torch.ops import limb
        from crescent_tpu_torch.ops.ec import points_valid
        from crescent_tpu_torch.ops.msm import get_msm

        pvk = made.setdefault("pvk", pk.vk.prepare())
        pubs = z[1:r1cs.num_instance]
        t0 = time.perf_counter()
        prepared = groth16.prepare_inputs(pk.vk, pubs, device)
        t1 = time.perf_counter()
        ok = groth16.verify_with_prepared_inputs(pvk, made["proof"], prepared)
        t2 = time.perf_counter()
        m, pts = get_msm(BN254_G1), pk.vk.gamma_abc_g1[1:]
        P = m.ctx.points_to_device(pts, device)
        valid = torch.from_numpy(points_valid(pts)).to(device)
        sc = limb.limbs_to_words(limb.ints_to_limbs([x % m.ctx.n for x in pubs]), device)
        sync()
        t3 = time.perf_counter()
        m.run_device(P.x, P.y, valid, sc)
        t4 = time.perf_counter()
        sync()
        t5 = time.perf_counter()
        return {"wall": t2 - t0, "ok": ok,
                "timings": {"prepare_inputs": t1 - t0, "pairing": t2 - t1,
                            "msm_enqueue": t4 - t3, "msm_to_device_end": t5 - t3}}

    def run(cfg: str) -> dict:
        env = CONFIGS[cfg]
        old = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            return verify() if cfg == "verify" else prove()
        finally:
            for k, v in old.items():
                if v is None:
                    os.environ.pop(k)
                else:
                    os.environ[k] = v

    for cfg in sorted(configs, key=lambda c: c == "verify"):  # verify needs a proof
        run(cfg)
    print(json.dumps({"ready": root}), flush=True)
    for line in sys.stdin:
        print(json.dumps(run(line.strip())), flush=True)


def _ask(proc, cfg: str) -> dict:
    proc.stdin.write(cfg + "\n")
    proc.stdin.flush()
    line = proc.stdout.readline()
    if not line:
        sys.exit("prove_pairs: a worker ended")
    return json.loads(line)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("other", nargs="?")
    ap.add_argument("--log2", type=int, default=21)
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--configs", nargs="+", choices=list(CONFIGS), default=list(PROVES))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--worker", metavar="ROOT")
    args = ap.parse_args()
    if args.worker:
        worker(args.worker, args.log2, args.device, args.configs)
        return
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        sys.exit("prove_pairs: needs a CUDA card")
    if args.device == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True).stdout.strip(), flush=True)
    trees = {"other": os.path.abspath(args.other), "this": HERE}
    procs = {}
    try:
        for name, root in trees.items():  # one at a time: set-ups do not overlap
            procs[name] = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--worker", root,
                 "--log2", str(args.log2), "--device", args.device,
                 "--configs", *args.configs],
                stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
            if not procs[name].stdout.readline():
                sys.exit(f"prove_pairs: the worker in {root} failed")
            print(f"{name} ready: {root}", flush=True)
        walls = {(cfg, t): [] for cfg in args.configs for t in trees}
        phases = {(cfg, t): [] for cfg in args.configs for t in trees}
        proofs = set()
        for i in range(args.pairs):
            for cfg in args.configs:
                for t in (("other", "this") if i % 2 == 0 else ("this", "other")):
                    res = _ask(procs[t], cfg)
                    walls[cfg, t].append(res["wall"])
                    phases[cfg, t].append(res["timings"])
                    if cfg == "verify" and not res["ok"]:
                        sys.exit(f"prove_pairs: {t} rejected the proof")
                    if cfg != "verify":
                        proofs.add(res["proof"])
                    print(f"pair {i} {cfg} {t}: {res['wall']:.3f} s", flush=True)
        if len(proofs) > 1:
            sys.exit("prove_pairs: the proofs differ")
        for cfg in args.configs:
            for t in trees:
                w = walls[cfg, t]
                q1, med, q3 = statistics.quantiles(w, n=4)
                print(f"{cfg} {t}: median {med:.3f} s, quartiles {q1:.3f} / {q3:.3f} s "
                      f"over {len(w)} runs")
            diff = [b - a for a, b in zip(walls[cfg, "other"], walls[cfg, "this"])]
            print(f"{cfg}: this - other, median of {len(diff)} pairs {statistics.median(diff):+.3f} s; "
                  f"this faster in {sum(d < 0 for d in diff)} of {len(diff)}")
            for ph in phases[cfg, "this"][0]:
                med = {t: statistics.median(p[ph] for p in phases[cfg, t]) for t in trees}
                d = statistics.median(b[ph] - a[ph] for a, b in
                                      zip(phases[cfg, "other"], phases[cfg, "this"]))
                print(f"  {ph}: other {med['other']:.3f} s, this {med['this']:.3f} s, "
                      f"median pair difference {d:+.3f} s")
        print(json.dumps({f"{cfg} {t}": w for (cfg, t), w in walls.items()}))
    finally:
        for p in procs.values():
            p.kill()
            p.wait()


if __name__ == "__main__":
    main()
