#!/usr/bin/env python3
"""Times the latency-bound chain kernels of the fold, `inv`, `jdbl_n` and
`jadd` over Fq (G1) and over Fq2 (G2), at the prove path's shapes, and
compares trees in turns.

    python3 scripts/time_chain_kernels.py [--root DIR]
    python3 scripts/time_chain_kernels.py --turns ROOT [ROOT ...] [--rounds N]

The first form builds the kernels of the port in DIR (default: this
checkout), checks `inv` at batch_inv's 512-lane root (over Fq and Fq2),
`jdbl_n` at the window combine's five launches of a chunk (16 lanes x 11,
8 x 22, 4 x 44, 2 x 88, 1 x 176 doublings) and `jadd` at the distinct
shapes of a chunk's 27 launches (the bucket aggregate's 11 suffix-sum
levels of 25,625 lanes and its weight tree of 12,800 down to 25, the
window combine's 16 down to 1, the fold's one lane) and at 2^17 lanes,
over Fq and Fq2, bit-equal to their plain versions on the card (`jadd`'s
inputs with P == Q, P == -Q and each side at the identity planted in
lanes 16 to 19), times each by CUDA events around a CUDA graph of many
launches (a mean, after a warm-up: the kernels' time on the card without
the host's time a call; `jadd` on seeded lanes without those edges, as
the aggregate's are), sums a chunk's `jadd` launches and prints one JSON
line.  The second builds this checkout and every ROOT at once (one nvcc a
source), then runs the first form in subprocesses on each in turns (N
rounds, default 2, the order rotated and reversed from round to round), so
every build is measured on one card, and prints the medians side by side
with the card's name and power limit.

Needs a CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 20261017
SHAPES = ((16, 11), (8, 22), (4, 44), (2, 88), (1, 176))
W, B = 25, 1025  # a chunk's windows and buckets (c = 11)
# a chunk's jadd launches: the suffix sums, the weight tree, the window
# combine, the fold's accumulator
JADD_CHUNK = ([W * B] * 11 + [W * ((B - 1) >> k) for k in range(1, 11)]
              + [16, 8, 4, 2, 1] + [1])
JADD_SHAPES = sorted(set(JADD_CHUNK), reverse=True) + [1 << 17]
INV_LANES = 512
REPS = 200


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()


def measure(root: str) -> dict:
    """Build the port in `root`, check and time its inv and jdbl_n over Fq
    and Fq2."""
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("time_chain_kernels: needs a CUDA card")
    sys.path.insert(0, root)
    from crescent_tpu_torch.core import fields
    from crescent_tpu_torch.ops import _build
    from crescent_tpu_torch.ops.cuda_ec import get_cuda_ec, get_cuda_quad_ec

    _build.build_all(("ec", "ec2"))
    p = fields.BN254_FQ
    rng = np.random.default_rng(SEED)

    def elems(n: int, width: int) -> torch.Tensor:
        """n seeded rows of `width` words: elements of Fq (8) or Fq2 (16)."""
        w = rng.integers(0, 1 << 32, size=(n, width), dtype=np.uint64)
        for top in range(7, width, 8):
            w[:, top] = rng.integers(0, p >> 224, size=n, dtype=np.uint64)
        return torch.from_numpy(w.astype(np.uint32).view(np.int32)).cuda()

    def time_ms(fn) -> float:
        """Device milliseconds a call: REPS calls captured in one CUDA graph
        and replayed, so the host's time a call (about 27 us of Python and
        ctypes, longer than a narrow launch's kernel) stays out."""
        fn()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(REPS):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / REPS

    out = {"root": root, "card": _card()}
    for prefix, ec, width in (("", get_cuda_ec(p), 8), ("fq2_", get_cuda_quad_ec(p), 16)):
        x = elems(INV_LANES, width)
        x[0] = 0
        if not torch.equal(ec.inv(x), ec.inv_plain(x)):
            sys.exit(f"time_chain_kernels: {prefix}inv differs from its plain version in {root}")
        out[f"{prefix}inv 512 lanes"] = time_ms(lambda: ec.inv(x))
        pt = [elems(16, width) for _ in range(3)]
        pt[2][3] = 0  # an identity lane, as the combine's padding rows are
        for lanes, count in SHAPES:
            pl = [a[:lanes].contiguous() for a in pt]
            got = ec.jdbl_n(*pl, count)
            if not all(torch.equal(g, w) for g, w in zip(got, ec.jdbl_n_plain(*pl, count))):
                sys.exit(f"time_chain_kernels: {prefix}jdbl_n {lanes} x {count} differs in {root}")
            out[f"{prefix}jdbl_n {lanes} x {count}"] = time_ms(lambda: ec.jdbl_n(*pl, count))
        pq = [elems(1 << 17, width) for _ in range(6)]
        ctx = ec.ctx
        # the edges in lanes 16..19: checked from 25 lanes up (the narrower
        # shapes' edges are the card tests' and chip_smoke.py's)
        pq[3][16], pq[4][16], pq[5][16] = pq[0][16], pq[1][16], pq[2][16]  # P == Q
        pq[3][17], pq[4][17], pq[5][17] = pq[0][17], ctx.neg_mod(pq[1][17:18])[0], pq[2][17]
        pq[2][18] = 0  # P the identity
        pq[5][19] = 0  # Q the identity
        # timed on lanes with none of those edges, as the aggregate's are
        # (a lane with P == Q takes the doubling's rounds too)
        pr = [elems(1 << 17, width) for _ in range(6)]
        chunk = 0.0
        for lanes in JADD_SHAPES:
            pl = [a[:lanes].contiguous() for a in pq]
            if not all(torch.equal(g, w) for g, w in zip(ec.jadd(*pl), ec.jadd_plain(*pl))):
                sys.exit(f"time_chain_kernels: {prefix}jadd {lanes} lanes differs in {root}")
            pl = [a[:lanes].contiguous() for a in pr]
            ms = out[f"{prefix}jadd {lanes} lanes"] = time_ms(lambda: ec.jadd(*pl))
            chunk += JADD_CHUNK.count(lanes) * ms
        out[f"{prefix}jadd a chunk ({len(JADD_CHUNK)} launches)"] = chunk
    return out


def build(roots: list[str]) -> dict[str, str]:
    """Build `ec` and `ec2` in every root at once (one process a root, one
    nvcc a source); returns nvcc's register report per root."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from crescent_tpu_torch.ops import _build; "
            "print('\\n'.join(_build.build_all(('ec', 'ec2')).values()))")
    procs = [subprocess.Popen([sys.executable, "-c", code, root], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for root in roots]
    reports = {}
    for root, proc in zip(roots, procs):
        reports[root], _ = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"time_chain_kernels: the build in {root} failed:\n{reports[root]}")
    return reports


def turns(others: list[str], rounds: int) -> None:
    roots = [HERE] + others
    build(roots)
    runs = {root: [] for root in roots}
    for r in range(rounds):
        order = roots[r % len(roots):] + roots[:r % len(roots)]
        for root in (order if r % 2 == 0 else order[::-1]):
            res = subprocess.run([sys.executable, os.path.abspath(__file__), "--root", root],
                                 capture_output=True, text=True)
            if res.returncode != 0:
                sys.exit(f"time_chain_kernels: the run in {root} failed:\n{res.stdout}{res.stderr}")
            line = json.loads(res.stdout.strip().splitlines()[-1])
            print(json.dumps(line), flush=True)
            runs[root].append(line)
    print(runs[HERE][0]["card"])
    for k in (k for k in runs[HERE][0] if k not in ("root", "card")):
        this = statistics.median(r[k] for r in runs[HERE])
        cols = [f"this {this:.5f} ms {[r[k] for r in runs[HERE]]}"]
        for root in others:
            t = [r[k] for r in runs[root]]
            m = statistics.median(t)
            cols.append(f"{os.path.relpath(root, HERE)} {m:.5f} ms {t}, / this {m / this:.2f}")
        print(f"{k}: " + "; ".join(cols))
    print(json.dumps({os.path.relpath(root, HERE): runs[root] for root in roots}))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--turns", metavar="ROOT", nargs="+")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if args.turns:
        turns([os.path.abspath(t) for t in args.turns], args.rounds)
    else:
        print(json.dumps(measure(os.path.abspath(args.root))), flush=True)


if __name__ == "__main__":
    main()
