#!/usr/bin/env python3
"""Times the latency-bound chain kernels of the fold, `inv`, `jdbl_n`,
`jadd`, `batch_inv` and the fused aggregate `bucket_reduce`, the fixed
base's window kernel `fixed_base`, and the older point kernels `madd`,
`jdbl`, `affine_denom` and `affine_add` (the pair additions), over
Fq (G1) and over Fq2 (G2), at the prove path's shapes, and compares trees
in turns.

    python3 scripts/time_chain_kernels.py [--root DIR] [--kernels NAME ...]
    python3 scripts/time_chain_kernels.py --turns ROOT [ROOT ...] [--rounds N]
        [--kernels NAME ...]

The first form builds the kernels of the port in DIR (default: this
checkout), checks `inv` at batch_inv's 512-lane root (over Fq and Fq2),
`jdbl_n` at the window combine's five launches of a chunk (16 lanes x 11,
8 x 22, 4 x 44, 2 x 88, 1 x 176 doublings) and `jadd` at the distinct
shapes of a chunk's 27 launches (the bucket aggregate's 11 suffix-sum
levels of 25,625 lanes and its weight tree of 12,800 down to 25, the
window combine's 16 down to 1, the fold's one lane) and at 2^17 lanes,
over Fq and Fq2, bit-equal to their plain versions on the card (`jadd`'s
inputs with P == Q, P == -Q and each side at the identity planted in
lanes 16 to 19), and `msm_affine.batch_inv` at the distinct shapes of a
chunk's 22 calls (2^21 down to 32,768 leaves, floor 512) on seeded
nonzero leaves, equal to the card's own tree of `mul` and `inv` where the
tree has the `batch_inv` kernel (there it also times that tree) and with
d * (1/d) == 1 where it has not (a tree before the kernel: `batch_inv` is
then that tree), `bucket_reduce` at a chunk's 25 windows of 1025 buckets
(seeded rows, the top bucket empty) equal to the card's unfused levels
(`bucket_levels` over the `jadd` kernel, 21 launches, which it also
times), the fixed base's 32 windows at 2^16 scalars (`fixed_base` where
the port has it, and the chain of 32 row gathers and `madd` launches it
replaces, both equal to the plain chain on their first 2^12 lanes), and
`madd` at setup's 2^16 lanes, `jdbl` at 1 (verify's public input),
1,024 (the small MSM) and 2^17 lanes and at 32 to 65,536 between (its
executors' switch-overs), `affine_denom` and `affine_add` at a chunk's
first pair level of 2^21 lanes (`affine_add` also at a chunk's 22
pair-level calls, one graph of the 22, and at each of their narrower
widths alone), each equal to its plain version on its first 2^12 lanes; times
each by CUDA events
around a CUDA graph of many launches (a mean, after a warm-up: the
kernels' time on the card without the host's time a call; `jadd` on
seeded lanes without those edges, as the aggregate's are), sums a
chunk's `jadd` and `batch_inv` calls and prints one JSON line;
`--kernels` picks some of KERNELS (default: all).  The second builds this checkout and every ROOT at once (one nvcc a
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


KERNELS = ("inv", "jdbl_n", "jadd", "batch_inv", "bucket_reduce", "madd", "fixed_base",
           "jdbl", "affine_denom", "affine_add")
OLDER = ("madd", "jdbl", "affine_denom", "affine_add")  # the rows PR 3-6 timed in event loops


def measure(root: str, kernels=KERNELS) -> dict:
    """Build the port in `root`, check and time `kernels` over Fq and
    Fq2."""
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

    def time_ms(fn, reps: int = REPS) -> float:
        """Device milliseconds a call: `reps` calls captured in one CUDA
        graph and replayed, so the host's time a call (about 27 us of Python
        and ctypes, longer than a narrow launch's kernel) stays out."""
        fn()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    out = {"root": root, "card": _card()}
    for prefix, ec, width in (("", get_cuda_ec(p), 8), ("fq2_", get_cuda_quad_ec(p), 16)):
        if "inv" in kernels:
            x = elems(INV_LANES, width)
            x[0] = 0
            if not torch.equal(ec.inv(x), ec.inv_plain(x)):
                sys.exit(f"time_chain_kernels: {prefix}inv differs from its plain version "
                         f"in {root}")
            out[f"{prefix}inv 512 lanes"] = time_ms(lambda: ec.inv(x))
        pt = [elems(16, width) for _ in range(3)]
        pt[2][3] = 0  # an identity lane, as the combine's padding rows are
        for lanes, count in SHAPES if "jdbl_n" in kernels else ():
            pl = [a[:lanes].contiguous() for a in pt]
            got = ec.jdbl_n(*pl, count)
            if not all(torch.equal(g, w) for g, w in zip(got, ec.jdbl_n_plain(*pl, count))):
                sys.exit(f"time_chain_kernels: {prefix}jdbl_n {lanes} x {count} differs in {root}")
            out[f"{prefix}jdbl_n {lanes} x {count}"] = time_ms(lambda: ec.jdbl_n(*pl, count))
        if "jadd" in kernels:
            _jadd(ec, prefix, root, elems, time_ms, out)
        if "batch_inv" in kernels:
            calls = _chunk_batch_inv_shapes()
            _batch_inv(ec, prefix, root, calls, elems(max(calls), width), time_ms, out)
        if "bucket_reduce" in kernels:
            _bucket_reduce(ec, prefix, root, elems, time_ms, out)
        if "fixed_base" in kernels:
            _fixed_base(ec, prefix, root, elems, time_ms, out)
        for name in (k for k in OLDER if k in kernels):
            _older(ec, prefix, name, root, elems, time_ms, out)
    return out


def _bucket_reduce(ec, prefix, root, elems, time_ms, out) -> None:
    """`bucket_reduce` at a chunk's W x B table against the card's unfused
    levels (bucket_levels over `jadd`), both timed."""
    import torch

    from crescent_tpu_torch.ops.cuda_ec import bucket_levels

    table = [elems(W * B, ec.WIDTH) for _ in range(3)]
    for a in table:
        a.view(W, B, -1)[:, B - 1] = 0  # an empty bucket in every window
    got = ec.bucket_reduce(*table, W, B)
    if not all(torch.equal(g, w) for g, w in zip(got, bucket_levels(ec.jadd, *table, W, B))):
        sys.exit(f"time_chain_kernels: {prefix}bucket_reduce differs from the levels in {root}")
    out[f"{prefix}bucket_reduce {W} x {B}"] = time_ms(lambda: ec.bucket_reduce(*table, W, B), 20)
    out[f"{prefix}bucket_reduce levels {W} x {B}"] = time_ms(
        lambda: bucket_levels(ec.jadd, *table, W, B), 20)


FB_LANES = 1 << 16  # a chunk of setup's fixed base


def _fixed_base(ec, prefix, root, elems, time_ms, out) -> None:
    """The fixed base's 32 windows at a chunk of 2^16 seeded scalars (a
    table of seeded rows): the `fixed_base` kernel where the port has it,
    and the chain it replaces, 32 row gathers (`index_select`) and `madd`
    launches (written out here: a checkout before the kernel has no
    `fixed_base_windows`), both checked against the plain chain on the
    first 2^12 lanes and timed as graph replays."""
    import numpy as np
    import torch

    width = ec.WIDTH
    table = torch.cat([elems(8192, width), elems(8192, width)], dim=1)
    rng = np.random.default_rng(SEED + 7)
    sc = torch.from_numpy(rng.integers(0, 1 << 32, size=(FB_LANES, 8), dtype=np.uint64)
                          .astype(np.uint32).view(np.int32)).cuda()
    digits = sc.view(torch.uint8).to(torch.int64).T
    rows = (digits + torch.arange(32, device="cuda")[:, None] * 256).contiguous()
    valid = (digits != 0).to(torch.int32).contiguous()
    sign = torch.zeros(FB_LANES, dtype=torch.int32, device="cuda")
    zero = torch.zeros((FB_LANES, width), dtype=torch.int32, device="cuda")

    def chain(madd, n=FB_LANES):
        acc = (zero[:n], zero[:n], zero[:n])
        for w in range(32):
            g = table.index_select(0, rows[w, :n])
            acc = madd(*acc, g[:, :width], g[:, width:], valid[w, :n], sign[:n])
        return acc

    head = 1 << 12
    want = chain(ec.madd_plain, head)
    got = [chain(ec.madd, head)]
    kernel = getattr(ec, "fixed_base", None)
    if kernel:
        got.append(kernel(table, sc[:head].contiguous()))
    if not all(torch.equal(g, w) for res in got for g, w in zip(res, want)):
        sys.exit(f"time_chain_kernels: {prefix}fixed_base differs from the plain chain in {root}")
    chain_ms = out[f"{prefix}fixed_base chain {FB_LANES} lanes"] = time_ms(
        lambda: chain(ec.madd), 4)
    out[f"{prefix}fixed_base {FB_LANES} lanes"] = (
        time_ms(lambda: kernel(table, sc), 20) if kernel else chain_ms)


# the older point kernels' shapes: madd at setup's chunk, jdbl at its
# callers' (verify's one lane, the small MSM's 1,024), at 2^17 and between
# (its executors' switch-overs), the pair kernels at a chunk's first pair
# level
OLDER_LANES = {"madd": (1 << 16,),
               "jdbl": (1, 32, 128, 255, 256, 257, 384, 512, 768, 1024, 4096, 8192, 16384,
                        32768, 65536, 1 << 17)}


def _older(ec, prefix, name, root, elems, time_ms, out) -> None:
    """One of the older point kernels at its path's shapes on seeded lanes,
    checked against its plain version on the first 2^12 lanes; affine_add
    also at a chunk's 22 pair-level calls, timed as one graph."""
    for lanes in OLDER_LANES.get(name, (1 << 21,)):
        _older_at(ec, prefix, name, lanes, root, elems, time_ms, out)


def _older_at(ec, prefix, name, lanes, root, elems, time_ms, out) -> None:
    import numpy as np
    import torch

    rng = np.random.default_rng(SEED + len(name))

    def flags(zero_in: int):
        return torch.from_numpy((rng.integers(0, zero_in, size=lanes) != 0)
                                .astype(np.int32)).cuda()

    rows = [elems(lanes, ec.WIDTH) for _ in range(5)]
    if name == "madd":  # valid == 0 for about one lane in 64, sign seeded
        args = (*rows, flags(64), flags(2))
    elif name == "jdbl":
        args = tuple(rows[:3])
    elif name == "affine_denom":  # about one side in 64 invalid
        args = (rows[0], rows[1], flags(64), rows[2], rows[3], flags(64))
    else:
        args = (rows[0], rows[1], flags(64), rows[2], rows[3], flags(64), rows[4])
    fn, plain = getattr(ec, name), getattr(ec, name + "_plain")
    head = tuple(a[:1 << 12].contiguous() for a in args)
    got, want = fn(*head), plain(*head)
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        sys.exit(f"time_chain_kernels: {prefix}{name} differs from its plain version in {root}")
    out[f"{prefix}{name} {lanes} lanes"] = time_ms(lambda: fn(*args),
                                                   max(10, min(REPS, (1 << 24) // lanes)))
    if name == "affine_add":  # a chunk's 22 calls: 2 mn and mn lanes a round
        widths = _chunk_batch_inv_shapes()
        calls = [tuple(a[:w] for a in args) for w in widths]
        out[f"{prefix}affine_add a chunk ({len(calls)} calls)"] = time_ms(
            lambda: [fn(*c) for c in calls], 5)
        for w in sorted(set(widths), reverse=True)[1:]:  # each narrower width alone
            part = tuple(a[:w] for a in args)
            out[f"{prefix}affine_add {w} lanes"] = time_ms(
                lambda: fn(*part), max(10, min(REPS, (1 << 24) // w)))


def _jadd(ec, prefix, root, elems, time_ms, out) -> None:
    """`jadd` at a chunk's shapes and 2^17, checked with the edges planted
    and timed without them; and a chunk's sum."""
    import torch

    width = ec.WIDTH
    ctx = ec.ctx
    pq = [elems(1 << 17, width) for _ in range(6)]
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


def _chunk_batch_inv_shapes() -> list[int]:
    """The leaves of a 2^17-point chunk's 22 batch_inv calls at c = 11, from
    the port on sys.path: each round's two pair levels, 2 mn and mn lanes
    (AffineMSM._round_schedule)."""
    from crescent_tpu_torch.core.curves import BN254_G1
    from crescent_tpu_torch.ops.ec import get_curve_ctx
    from crescent_tpu_torch.ops.msm_affine import AffineMSM

    ctx = get_curve_ctx(BN254_G1)
    return [w for mn in AffineMSM(ctx, ctx.ec, c=11)._round_schedule(1 << 17)
            for w in (2 * mn, mn)]


def _batch_inv(ec, prefix, root, calls, d, time_ms, out) -> None:
    """`msm_affine.batch_inv` at the distinct shapes of a chunk's `calls`
    on the first rows of d: the kernel where this tree has it (and the tree
    of mul and inv beside it), else the tree; and a chunk's sums."""
    import torch

    from crescent_tpu_torch.ops import cuda_ec
    from crescent_tpu_torch.ops.msm_affine import batch_inv

    tree = getattr(cuda_ec, "batch_inv_tree", None)
    one = ec.ctx.one_mont("cuda")
    chunk = tree_chunk = 0.0
    for lanes in sorted(set(calls), reverse=True):
        x = d[:lanes]
        got = batch_inv(ec, x)
        ok = (torch.equal(got, tree(ec.mul, ec.inv, x)) if tree
              else bool((ec.mul(x, got) == one).all()))
        if not ok:
            sys.exit(f"time_chain_kernels: {prefix}batch_inv {lanes} lanes is wrong in {root}")
        reps = max(10, min(REPS, (1 << 24) // lanes))
        ms = out[f"{prefix}batch_inv {lanes} lanes"] = time_ms(lambda: batch_inv(ec, x), reps)
        chunk += calls.count(lanes) * ms
        if tree:
            t_ms = out[f"{prefix}batch_inv tree {lanes} lanes"] = time_ms(
                lambda: tree(ec.mul, ec.inv, x), reps)
            tree_chunk += calls.count(lanes) * t_ms
    out[f"{prefix}batch_inv a chunk ({len(calls)} calls)"] = chunk
    if tree:
        out[f"{prefix}batch_inv tree a chunk ({len(calls)} calls)"] = tree_chunk


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


def turns(others: list[str], rounds: int, kernels) -> None:
    roots = [HERE] + others
    build(roots)
    runs = {root: [] for root in roots}
    for r in range(rounds):
        order = roots[r % len(roots):] + roots[:r % len(roots)]
        for root in (order if r % 2 == 0 else order[::-1]):
            res = subprocess.run([sys.executable, os.path.abspath(__file__), "--root", root,
                                  "--kernels", *kernels], capture_output=True, text=True)
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
            t = [r[k] for r in runs[root] if k in r]
            if not t:  # a key only this tree has (the tree beside the kernel)
                continue
            m = statistics.median(t)
            cols.append(f"{os.path.relpath(root, HERE)} {m:.5f} ms {t}, / this {m / this:.2f}")
        print(f"{k}: " + "; ".join(cols))
    print(json.dumps({os.path.relpath(root, HERE): runs[root] for root in roots}))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--turns", metavar="ROOT", nargs="+")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--kernels", nargs="+", choices=KERNELS, default=list(KERNELS))
    args = ap.parse_args()
    if args.turns:
        turns([os.path.abspath(t) for t in args.turns], args.rounds, args.kernels)
    else:
        print(json.dumps(measure(os.path.abspath(args.root), args.kernels)), flush=True)


if __name__ == "__main__":
    main()
