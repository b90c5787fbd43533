#!/usr/bin/env python3
"""Where one chunk MSM of the port spends its time on the card.

    python3 scripts/profile_msm_chunk.py [log2_points] [c] [g1|g2]

Builds the CUDA kernels, makes 2^log2_points (default 17) seeded BN254 G1
points (or G2 points, over Fq2) and scalars, checks one ``AffineMSM.run``
(window width c, default 11) against the native host MSM, and then prints,
for one warm run:

* a split by stage from CUDA events around the stages (recode and sort,
  each round's compaction and gathers, the pair levels, ``batch_inv`` (one
  launch a call), the aggregate).  Events lie on the device's timeline, so
  a stage's time includes any wait for the host to enqueue its launches;
* the device time by kernel from ``torch.profiler`` (busy time only),
  grouped into the port's kernels, sorts, gathers and scatters, and the
  remaining elementwise PyTorch kernels; and the host's time to enqueue.

Needs a CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import functools
import os
import random
import subprocess
import sys
import time
from collections import defaultdict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        sys.exit("profile_msm_chunk: needs a CUDA card")
    from crescent_tpu_torch.core import curves
    from crescent_tpu_torch.native import backend as nb
    from crescent_tpu_torch.ops import _build, limb
    from crescent_tpu_torch.ops.ec import JPoints, get_curve_ctx, get_g2_ctx, points_valid
    from crescent_tpu_torch.ops.msm_affine import AffineMSM

    logn = int(sys.argv[1]) if len(sys.argv) > 1 else 17
    c = int(sys.argv[2]) if len(sys.argv) > 2 else 11
    group = sys.argv[3] if len(sys.argv) > 3 else "g1"
    if group not in ("g1", "g2"):
        sys.exit(f"profile_msm_chunk: group {group!r}: expected g1 or g2")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip(), flush=True)
    _build.build_all()

    if group == "g1":
        ctx = get_curve_ctx(curves.BN254_G1)
        make = functools.partial(nb.fixed_base, "bn254_g1", curves.BN254_G1.generator)
        native = functools.partial(nb.msm, "bn254_g1")
    else:
        ctx = get_g2_ctx()
        make = functools.partial(nb.fixed_base_g2, curves.BN254G2.generator())
        native = nb.msm_g2
    rng = random.Random(17)
    n = 1 << logn
    pts = make([rng.randrange(1, ctx.n) for _ in range(n)])
    ks = [rng.randrange(ctx.n) for _ in range(n)]
    P = ctx.points_to_device(pts, "cuda")
    valid = torch.from_numpy(points_valid(pts)).cuda()
    sc = limb.limbs_to_words(limb.ints_to_limbs(ks), "cuda")
    am = AffineMSM(ctx, ctx.ec, c=c)
    res = am.run(P.x, P.y, valid, sc)
    got = ctx.points_to_host(JPoints(*(a[None] for a in res)))[0]
    assert got == native(ks, pts), "chunk MSM differs from the native MSM"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    am.run(P.x, P.y, valid, sc)
    torch.cuda.synchronize()
    print(f"{group} chunk MSM 2^{logn} points, c={c}: W={am.W} B={am.B}, rounds "
          f"{am._round_schedule(n)}; equals the native MSM; peak device memory "
          f"{(torch.cuda.max_memory_allocated() - base) / 2**20:.0f} MiB above its inputs",
          flush=True)

    # -- whole chunk: device time and host time to enqueue ------------------
    for _ in range(2):
        am.run(P.x, P.y, valid, sc)
    torch.cuda.synchronize()
    reps = 5
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0 = time.perf_counter()
    e0.record()
    for _ in range(reps):
        am.run(P.x, P.y, valid, sc)
    e1.record()
    enqueue = (time.perf_counter() - t0) / reps
    torch.cuda.synchronize()
    print(f"one chunk, mean of {reps}: {e0.elapsed_time(e1) / reps:.3f} ms on the "
          f"card's timeline, {enqueue * 1e3:.3f} ms for the host to enqueue", flush=True)

    # -- split by stage: events around the stages ----------------------------
    spans = []

    def wrap(obj, name, label):
        fn = getattr(obj, name)

        def timed(*a, **kw):
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
            out = fn(*a, **kw)
            e.record()
            spans.append((label, s, e))
            return out

        setattr(obj, name, timed)
        return lambda: setattr(obj, name, fn)

    undo = [wrap(am, m, m) for m in ("_survivors", "_round1", "_round",
                                     "_pair_levels", "_batch_inv", "_aggregate")]
    am.run(P.x, P.y, valid, sc)
    torch.cuda.synchronize()
    for u in undo:
        u()
    tot = defaultdict(float)
    for label, s, e in spans:
        tot[label] += s.elapsed_time(e)
    rounds = tot["_round1"] + tot["_round"]
    print("split by stage (CUDA events, ms; one run):")
    print(f"  recode, keys and the sort        {tot['_survivors'] - rounds:8.3f}")
    first_pl = next(s.elapsed_time(e) for label, s, e in spans if label == "_pair_levels")
    print(f"  round 1: ranks, compaction, gathers {tot['_round1'] - first_pl:6.3f}")
    print(f"  rounds: ranks, compaction, gathers {rounds - tot['_pair_levels']:6.3f}  (all rounds)")
    pair_ms = tot["_pair_levels"] - tot["_batch_inv"]
    print(f"  pair levels: affine_denom, affine_add, cats {pair_ms:8.3f}")
    calls = sum(1 for label, _, _ in spans if label == "_batch_inv")
    print(f"  batch_inv ({calls} calls)             {tot['_batch_inv']:8.3f}")
    print(f"  aggregate (scatter, jadd, jdbl_n) {tot['_aggregate']:8.3f}")
    print(f"  round 1 / later rounds            {tot['_round1']:8.3f} / {tot['_round']:.3f}")

    # -- device time by kernel ------------------------------------------------
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        am.run(P.x, P.y, valid, sc)
        torch.cuda.synchronize()
    groups = defaultdict(lambda: [0.0, 0])
    ours = ("batch_inv_kernel", "mul_kernel", "inv_kernel", "affine_denom_kernel",
            "affine_add_lane_kernel", "affine_add_halves_kernel", "jadd_kernel", "jdbl_n_kernel",
            "jdbl_kernel", "butterfly_kernel")
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", 0) or getattr(ev, "self_cuda_time_total", 0)
        if not dev_us or "cuda" not in str(getattr(ev, "device_type", "cuda")).lower():
            continue
        name = ev.key
        rows.append((dev_us, ev.count, name))
        mine = [k for k in ours if k in name]
        low = name.lower()
        if mine:
            g = "port kernel " + mine[0]
        elif "sort" in low or "radix" in low:
            g = "sort kernels"
        elif "index" in low or "gather" in low or "scatter" in low:
            g = "gather / scatter kernels"
        elif "scan" in low or "cummax" in low:
            g = "scan kernels (cummax)"
        elif "memcpy" in low or "memset" in low:
            g = "memcpy / memset"
        else:
            g = "elementwise and other PyTorch kernels"
        groups[g][0] += dev_us
        groups[g][1] += ev.count
    total = sum(v[0] for v in groups.values())
    if not total:
        print("torch.profiler reported no device time on this machine")
        return
    print(f"device time by kernel group (torch.profiler, one run): total {total / 1e3:.3f} ms "
          f"busy, {sum(v[1] for v in groups.values())} launches")
    for g, (us, cnt) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        print(f"  {g:45s} {us / 1e3:8.3f} ms  {100 * us / total:5.1f}%  {cnt:6d} launches")
    print("top 12 kernels:")
    for us, cnt, name in sorted(rows, reverse=True)[:12]:
        print(f"  {us / 1e3:8.3f} ms  {cnt:5d}x  {name[:110]}")


if __name__ == "__main__":
    main()
