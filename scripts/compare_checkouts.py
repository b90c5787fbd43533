#!/usr/bin/env python3
"""Holds this checkout's CUDA build and plain versions against another
checkout's of the port (its parent commit, say), on one card.

    python3 scripts/compare_checkouts.py OTHER_ROOT [--device cuda] [--rows N]
        [--skip-build]

Two checks, each checkout in a process of its own:

* the build: every library (`ntt`, `ec`, `ec2`) is built by each
  checkout's own ``_build`` into a fresh directory, and each kernel entry's
  registers and spill store bytes (``nvcc -Xptxas -v``) and its SASS
  (``cuobjdump -sass``) are compared.  An instance of this checkout is
  matched to the other's by its mangled name with template arguments
  ``false`` (``Lb0E``) taken out, as a new defaulted bool parameter adds
  them; the instances only this checkout has are listed and not compared.
* the plain versions: the same seeded inputs (BN254 Fq and Fr rows with 0,
  1, p - 1, p - 2, 2^255 - 19 mod p and R mod p planted; Jacobian batches
  over Fq with a = 0 and a = 5 and over Fq2 with P + P, P + (-P) and the
  identity on either side and both planted) go through each checkout's
  ``mont_mul``, ``add_mod`` and ``sub_mod`` and ``cuda_ec``'s ``mul_plain``,
  ``jadd_plain`` and ``jdbl_plain`` on `--device` tensors.

It prints a line per library and per op and exits 1 if an entry of the
other checkout is missing here, or differs in registers, spills or SASS, or
if any plain output differs.  With --device cpu and --skip-build it runs
without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIBS = ("ntt", "ec", "ec2")
SEED = 19


# -- workers (run with a checkout's root first on sys.path) -----------------

def _build_worker(root: str, out_dir: str, result: str) -> None:
    """Build every library of the checkout into `out_dir`; write
    {lib: [so path, nvcc output]}."""
    from crescent_tpu_torch.ops import _build

    _build.BUILD_DIR = out_dir
    reports = _build.build_all(LIBS)
    with open(result, "w") as f:
        json.dump({lib: [_build._so_path(lib), reports[lib]] for lib in LIBS}, f)


def _plain_inputs(torch, device: str, rows: int) -> dict:
    """Seeded word tensors (int32) for _plain_worker, made from Python ints
    so that neither checkout's ops make them."""
    import numpy as np

    from crescent_tpu_torch.core.fields import BN254_FQ, BN254_FR
    from crescent_tpu_torch.ops.limb import get_ctx

    rng = np.random.default_rng(SEED)

    def elems(p: int, n: int) -> list[int]:
        words = rng.integers(0, 1 << 32, size=(n, 8), dtype=np.uint64)
        return [sum(int(w) << (32 * i) for i, w in enumerate(r)) % p for r in words]

    def plant(p: int, xs: list[int]) -> list[int]:
        edge = [0, 1, p - 1, p - 2, ((1 << 255) - 19) % p, (1 << 256) % p]
        return edge + xs[len(edge):]

    out = {}
    for name, p in (("fq", BN254_FQ), ("fr", BN254_FR)):
        ctx = get_ctx(p)
        x, y = plant(p, elems(p, rows)), elems(p, rows)
        y[: 6] = list(reversed(x[: 6]))
        out[name] = (ctx.words(x, device), ctx.words(y, device))
    ctx = get_ctx(BN254_FQ)
    n = rows // 8
    for name, width in (("g1", 1), ("g2", 2)):
        coords = [[elems(BN254_FQ, n) for _ in range(width)] for _ in range(6)]
        x1, y1, z1, x2, y2, z2 = coords
        for c in range(width):
            x2[c][0], y2[c][0], z2[c][0] = x1[c][0], y1[c][0], z1[c][0]  # P + P
            x2[c][1], z2[c][1] = x1[c][1], z1[c][1]  # P + (-P)
            y2[c][1] = (BN254_FQ - y1[c][1]) % BN254_FQ
            z1[c][2] = z2[c][3] = z1[c][4] = z2[c][4] = 0  # the identity
            x1[c][5] = y1[c][5] = BN254_FQ - 1
        out[name] = tuple(torch.cat([ctx.words(v[c], device) for c in range(width)], dim=1)
                          for v in coords)
    return out


def _plain_worker(root: str, inputs: str, result: str, device: str) -> None:
    """Run the plain ops of the checkout on the inputs; save the outputs."""
    import torch

    from crescent_tpu_torch.core.fields import BN254_FQ, BN254_FR
    from crescent_tpu_torch.ops.cuda_ec import get_cuda_ec, get_cuda_quad_ec

    data = {k: tuple(t.to(device) for t in v) for k, v in torch.load(inputs).items()}
    out = {}
    for name, p in (("fq", BN254_FQ), ("fr", BN254_FR)):
        ec = get_cuda_ec(p)
        x, y = data[name]
        out[f"{name} mont_mul"] = ec.ctx.mont_mul(x, y)
        out[f"{name} mont_sqr"] = ec.ctx.mont_sqr(x)
        out[f"{name} add_mod"] = ec.ctx.add_mod(x, y)
        out[f"{name} sub_mod"] = ec.ctx.sub_mod(x, y)
        out[f"{name} mul_plain"] = ec.mul_plain(x, y[:1])
    for label, ec, key in (("fq a = 0", get_cuda_ec(BN254_FQ, 0), "g1"),
                           ("fq a = 5", get_cuda_ec(BN254_FQ, 5), "g1"),
                           ("fq2", get_cuda_quad_ec(BN254_FQ), "g2")):
        pq = data[key]
        out[f"{label} mont_mul"] = ec.ctx.mont_mul(pq[0], pq[1])
        out[f"{label} jadd_plain"] = torch.cat(ec.jadd_plain(*pq), dim=1)
        out[f"{label} jdbl_plain"] = torch.cat(ec.jdbl_plain(*pq[:3]), dim=1)
    torch.save({k: v.cpu() for k, v in out.items()}, result)


# -- the comparisons ---------------------------------------------------------

def _run_worker(root: str, *args: str) -> None:
    env = dict(os.environ, PYTHONPATH=root)
    subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", root, *args],
                   check=True, env=env, cwd=root)


def _registers(report: str) -> dict:
    """nvcc -Xptxas -v output -> {mangled entry: (registers, spill store
    bytes)}, an entry's spills with its callees' (chip_smoke.py's reading)."""
    out, entry, spill = {}, None, 0
    for ln in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            entry, spill = m.group(1), 0
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m and entry:
            spill += int(m.group(1))
            if entry in out:
                out[entry] = (out[entry][0], spill)
        m = re.search(r"Used (\d+) registers", ln)
        if m and entry:
            out[entry] = (int(m.group(1)), spill)
    return out


def _sass(so: str) -> dict:
    """cuobjdump -sass of a library -> {mangled function: its SASS text}."""
    cuobjdump = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", so], check=True, capture_output=True,
                          text=True).stdout
    out, name = {}, None
    for ln in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", ln)
        if m:
            name = m.group(1)
            out[name] = []
        elif name and "/*" in ln:
            out[name].append(ln.strip())
    return {k: "\n".join(v) for k, v in out.items()}


def _nvcc() -> str:
    sys.path.insert(0, ROOT)
    from crescent_tpu_torch.ops._build import nvcc_path

    return nvcc_path()


def _anon(name: str) -> str:
    """A mangled name with its anonymous namespace's per-build hash taken
    out (``_GLOBAL__N__<hash>_<file>``)."""
    return re.sub(r"_GLOBAL__N__[0-9a-f]+_", "_GLOBAL__N__", name)


def _match(mine: str, theirs: set):
    """The other checkout's name for an instance of this one, and the
    positions of the ``Lb0E`` template arguments taken out of `mine` to
    make it (fewest first, the rightmost first), or (None, ())."""
    import itertools

    spots = [m.start() for m in re.finditer("Lb0E", mine)]
    for k in range(len(spots) + 1):
        for drop in reversed(list(itertools.combinations(spots, k))):
            name = "".join(mine[i:j] for i, j in _keep(len(mine), drop))
            if name in theirs:
                return name, drop
    return None, ()


def _keep(n: int, drop) -> list:
    """The spans of a string of length n left when the 4-character spans
    starting at `drop` are taken out."""
    spans, at = [], 0
    for d in drop:
        spans.append((at, d))
        at = d + 4
    spans.append((at, n))
    return spans


def compare_builds(other: str, tmp: str) -> bool:
    ok = True
    builds = {}
    for tag, root in (("this", ROOT), ("other", other)):
        result = os.path.join(tmp, f"build_{tag}.json")
        _run_worker(root, "build", os.path.join(tmp, f"kernels_{tag}"), result)
        with open(result) as f:
            builds[tag] = json.load(f)
    for lib in LIBS:
        (so_a, rep_a), (so_b, rep_b) = builds["this"][lib], builds["other"][lib]
        regs_a, regs_b = ({_anon(k): v for k, v in _registers(rep).items()}
                          for rep in (rep_a, rep_b))
        sass_a, sass_b = ({_anon(k): v for k, v in _sass(so).items()} for so in (so_a, so_b))
        # where two of this checkout's instances reduce to one of the
        # other's, the one whose dropped arguments stand further right (a
        # new parameter comes last): <true, false> is <true>, not
        # <false, true>
        claims: dict = {}
        for name in regs_a:
            twin, drop = _match(name, set(regs_b))
            if twin is not None:
                claims.setdefault(twin, []).append((sorted(drop, reverse=True), name))
        matched = {max(c)[1]: twin for twin, c in claims.items()}
        new, differ = [n for n in regs_a if n not in matched], []
        missing = sorted(set(regs_b) - set(matched.values()))
        for name, twin in matched.items():
            if regs_a[name] != regs_b[twin] or sass_a.get(name) != sass_b.get(twin):
                differ.append(f"{twin}: registers, spills {regs_b[twin]} -> {regs_a[name]}, "
                              f"SASS {'same' if sass_a.get(name) == sass_b.get(twin) else 'differs'}")
        print(f"{lib}: {len(matched)} entries matched, {len(matched) - len(differ)} with the "
              f"same registers, spills and SASS; {len(differ)} differ; "
              f"{len(missing)} missing here; {len(new)} new here")
        for line in differ:
            print(f"  differs: {line}")
        for name in missing:
            print(f"  missing here: {name} {regs_b[name]}")
        for name in new:
            print(f"  new here: {name} {regs_a[name]}")
        ok = ok and not differ and not missing
    return ok


def compare_plain(other: str, tmp: str, device: str, rows: int) -> bool:
    import torch

    sys.path.insert(0, ROOT)
    inputs = os.path.join(tmp, "inputs.pt")
    torch.save({k: tuple(t.cpu() for t in v)
                for k, v in _plain_inputs(torch, "cpu", rows).items()}, inputs)
    outs = {}
    for tag, root in (("this", ROOT), ("other", other)):
        result = os.path.join(tmp, f"plain_{tag}.pt")
        _run_worker(root, "plain", inputs, result, device)
        outs[tag] = torch.load(result)
    ok = True
    for name, want in outs["other"].items():
        got = outs["this"][name]
        bad = int((got != want).any(dim=-1).sum()) if got.shape == want.shape else -1
        print(f"plain {name} on {device}: {want.shape[0]} rows, "
              + ("shapes differ" if bad < 0 else f"{bad} differ"))
        ok = ok and bad == 0
    return ok


def main() -> None:
    if sys.argv[1:2] == ["--worker"]:
        root, kind, *args = sys.argv[2:]
        sys.path.insert(0, root)
        (_build_worker if kind == "build" else _plain_worker)(root, *args)
        return
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("other", help="the root of the other checkout")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rows", type=int, default=1 << 18)
    ap.add_argument("--skip-build", action="store_true")
    args = ap.parse_args()
    other = os.path.abspath(args.other)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build") if os.path.isdir(
            os.path.join(ROOT, "build")) else None) as tmp:
        ok = compare_plain(other, tmp, args.device, args.rows)
        if not args.skip_build:
            ok = compare_builds(other, tmp) and ok
    print(json.dumps({"ok": ok}))
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
