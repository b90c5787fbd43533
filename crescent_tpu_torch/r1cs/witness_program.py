"""Witness-program compiler: turn a built R1CS (+ builder hints) into a
replayable witness program, so repeat proves of the same circuit shape skip
Python gadget execution entirely.

This is the framework's analog of circom's compiled witness calculator
(reference: forks/circom-compat/src/witness/witness_calculator.rs — there
the circom compiler emits a WASM module; here the builder's one recorded
synthesis is compiled into a flat op program executed by the native C++
backend, with a pure-Python reference executor for parity tests).

How wires get their values at replay:
  * input wires      — fed from prover inputs (ConstraintSystem.mark_input)
  * hint wires       — builder-recorded ops (bit decompositions, is_zero
                       inverses, one-hot indicators, bigint quotients, ...)
  * everything else  — constraint-directed solving: walking constraints in
                       emission order, a constraint with exactly one unknown
                       wire appearing linearly is solved for it; a linear
                       constraint whose unknowns all carry distinct
                       power-of-two coefficients is a (multi-width) bit
                       decomposition of its known residual.

Compilation fails loudly (CompileError with sample wires) when a circuit
allocates values the solver can't derive — callers fall back to the full
Python synthesis, so correctness never depends on this module.
"""

from __future__ import annotations

from dataclasses import dataclass


# op kinds (shared with the native executor)
OP_SOLVE_C = 0     # out = (evalA * evalB - evalCrest) * inv_coeff
OP_SOLVE_LIN = 1   # out = -(evalA_rest) * inv_coeff  (A*B=C with B=1, C=0 folded into A_rest)
OP_DECOMP = 2      # multi-width pow2 decomposition of residual
OP_HINT_DECOMP = 3 # bit decomposition of eval(terms)
OP_INV01 = 4       # is_zero: inv + out wires
OP_ONEHOT = 5      # one-hot indicator
OP_SHR = 6         # out = eval(terms) >> k
OP_NEGMOD = 7      # out = (-eval(terms)) mod 2^k
OP_SSHR_BIAS = 8   # out = (signed(eval) >> k) + bias
OP_DIVMOD = 9      # bigint (A*B) divmod n -> q/r limbs
OP_SOLVE_AB = 10   # single unknown in A or B row: needs runtime inversion
OP_NN_RED = 11     # (sum s*A*B + sum t*C) mod m -> out limbs
OP_NN_QUOT = 12    # (sum s*A*B + sum t*C) // m + bias -> out limbs
OP_NN_INV_MUL = 13 # (NUM * DEN^-1) mod m -> out limbs (0 if DEN == 0)


class CompileError(Exception):
    pass


@dataclass
class WitnessProgram:
    field: int
    num_vars: int
    ops: list
    input_layout: list          # [(name, [wire idx, ...]), ...]

    # -- replay -------------------------------------------------------------
    def input_vector(self, prover_inputs: dict) -> list[tuple[list[int], list[int]]]:
        """Map a prover-input dict to per-entry (wire idx, value) pairs using
        the same conventions as the frontends' val() helper (ints; lists
        truncated/padded to the recorded wire count; missing keys -> 0)."""
        out = []
        for name, idxs in self.input_layout:
            v = prover_inputs.get(name, 0)
            if isinstance(v, list):
                vals = [int(x) for x in v[: len(idxs)]]
            else:
                vals = [int(v)]
            vals += [0] * (len(idxs) - len(vals))
            out.append((idxs, vals[: len(idxs)]))
        return out

    def run(self, prover_inputs: dict) -> list[int]:
        """Pure-Python reference executor (exact, slow — parity tests only;
        production replay uses the native executor)."""
        F = self.field
        vals = [0] * self.num_vars
        vals[0] = 1
        for idxs, vv in self.input_vector(prover_inputs):
            for i, v in zip(idxs, vv):
                vals[i] = v % F

        def ev(terms):
            return sum(c * vals[i] for i, c in terms) % F

        half = F // 2
        for op in self.ops:
            kind = op[0]
            if kind == OP_SOLVE_C:
                _, out, invc, A, B, Crest = op
                vals[out] = (ev(A) * ev(B) - ev(Crest)) * invc % F
            elif kind == OP_SOLVE_LIN:
                _, out, invc, Arest = op
                vals[out] = ev(Arest) * invc % F
            elif kind == OP_DECOMP:
                _, outs, shifts, widths, neg, known = op
                r = ev(known) % F
                if not neg:
                    r = (-r) % F
                acc = 0
                for o, k, w in zip(outs, shifts, widths):
                    v = (r >> k) & ((1 << w) - 1)
                    vals[o] = v
                    acc += v << k
                if acc != r:
                    raise CompileError(
                        f"DECOMP residual mismatch: {acc} != {r}"
                    )
            elif kind == OP_HINT_DECOMP:
                _, terms, base, nbits = op
                v = ev(terms)
                for i in range(nbits):
                    vals[base + i] = (v >> i) & 1
            elif kind == OP_INV01:
                _, terms, inv_i, out_i = op
                x = ev(terms)
                vals[inv_i] = pow(x, -1, F) if x else 0
                vals[out_i] = 0 if x else 1
            elif kind == OP_ONEHOT:
                _, terms, base, n = op
                x = ev(terms)
                for j in range(n):
                    vals[base + j] = 1 if j == x else 0
            elif kind == OP_SHR:
                _, terms, out, k = op
                vals[out] = ev(terms) >> k
            elif kind == OP_NEGMOD:
                _, terms, out, k = op
                vals[out] = (-ev(terms)) % (1 << k)
            elif kind == OP_SSHR_BIAS:
                _, terms, out, k, bias = op
                v = ev(terms)
                if v > half:
                    v -= F
                vals[out] = ((v >> k) + bias) % F
            elif kind == OP_DIVMOD:
                _, a_terms, b_terms, n_int, q_idx, r_idx, limb_bits = op
                a = 0
                for li, t in enumerate(a_terms):
                    a |= ev(t) << (limb_bits * li)
                b = 0
                for li, t in enumerate(b_terms):
                    b |= ev(t) << (limb_bits * li)
                q, r = divmod(a * b, n_int)
                mask = (1 << limb_bits) - 1
                for li, o in enumerate(q_idx):
                    vals[o] = (q >> (limb_bits * li)) & mask
                for li, o in enumerate(r_idx):
                    vals[o] = (r >> (limb_bits * li)) & mask
            elif kind == OP_SOLVE_AB:
                _, out, invc, Rrest, other, C, out_in_a = op
                denom = ev(other)
                t = ev(C) * pow(denom, -1, F) - ev(Rrest)
                vals[out] = t * invc % F
            elif kind in (OP_NN_RED, OP_NN_QUOT):
                if kind == OP_NN_RED:
                    _, muls, lins, m_int, out_idx, limb_bits = op
                    bias = None
                else:
                    _, muls, lins, m_int, bias, out_idx, limb_bits = op

                def nn_val(limb_terms):
                    v = 0
                    for li, t in enumerate(limb_terms):
                        v |= ev(t) << (limb_bits * li)
                    return v

                total = 0
                for s, a, b in muls:
                    total += s * nn_val(a) * nn_val(b)
                for t, c in lins:
                    total += t * nn_val(c)
                out_v = total % m_int if bias is None else total // m_int + bias
                mask = (1 << limb_bits) - 1
                for li, o in enumerate(out_idx):
                    vals[o] = (out_v >> (limb_bits * li)) & mask
            elif kind == OP_NN_INV_MUL:
                _, nt, dt, m_int, out_idx, limb_bits = op

                def nn_lin(lins):
                    total = 0
                    for t, c in lins:
                        v = 0
                        for li, tt in enumerate(c):
                            v |= ev(tt) << (limb_bits * li)
                        total += t * v
                    return total

                den = nn_lin(dt) % m_int
                out_v = (
                    nn_lin(nt) * pow(den, -1, m_int) % m_int if den else 0
                )
                mask = (1 << limb_bits) - 1
                for li, o in enumerate(out_idx):
                    vals[o] = (out_v >> (limb_bits * li)) & mask
            else:
                raise CompileError(f"unknown op kind {kind}")
        return vals


    # -- native execution ---------------------------------------------------
    def serialize(self):
        """Flatten into the native executor's format: u32 code stream +
        deduplicated Montgomery coefficient table + big-constant pool.
        Cached on the instance."""
        if getattr(self, "_ser", None) is not None:
            return self._ser
        import numpy as np

        F = self.field
        code: list[int] = []
        coeff_ids: dict[int, int] = {}
        bigpool: list[int] = []  # u64 words

        def cid(c: int) -> int:
            c %= F
            i = coeff_ids.get(c)
            if i is None:
                i = coeff_ids[c] = len(coeff_ids)
            return i

        def terms(ts):
            code.append(len(ts))
            for i, c in ts:
                code.append(i)
                code.append(cid(c))

        def pool_put(x: int, words: int) -> int:
            off = len(bigpool)
            for w in range(words):
                bigpool.append((x >> (64 * w)) & 0xFFFFFFFFFFFFFFFF)
            return off

        def terms_at(ts):
            # emit terms WITHOUT the leading count (callers emit counts
            # in their header)
            for i, c in ts:
                code.append(i)
                code.append(cid(c))

        for op in self.ops:
            kind = op[0]
            if kind == OP_SOLVE_C:
                _, out, invc, A, B, Crest = op
                code += [0, out, cid(invc), len(A), len(B), len(Crest)]
                terms_at(A)
                terms_at(B)
                terms_at(Crest)
            elif kind == OP_SOLVE_LIN:
                _, out, invc, A = op
                code += [1, out, cid(invc), len(A)]
                terms_at(A)
            elif kind == OP_DECOMP:
                _, outs, shifts, widths, neg, known = op
                code += [2, len(outs), 1 if neg else 0, len(known)]
                for o, s, w in zip(outs, shifts, widths):
                    code += [o, s, min(w, 64)]
                terms_at(known)
            elif kind == OP_HINT_DECOMP:
                _, ts, base, nbits = op
                code += [3, base, nbits, len(ts)]
                terms_at(ts)
            elif kind == OP_INV01:
                _, ts, inv_i, out_i = op
                code += [4, inv_i, out_i, len(ts)]
                terms_at(ts)
            elif kind == OP_ONEHOT:
                _, ts, base, n = op
                code += [5, base, n, len(ts)]
                terms_at(ts)
            elif kind == OP_SHR:
                _, ts, out, k = op
                code += [6, out, k, len(ts)]
                terms_at(ts)
            elif kind == OP_NEGMOD:
                _, ts, out, k = op
                code += [7, out, k, len(ts)]
                terms_at(ts)
            elif kind == OP_SSHR_BIAS:
                _, ts, out, k, bias = op
                boff = pool_put(bias % F, 4)
                code += [8, out, k, boff, len(ts)]
                terms_at(ts)
            elif kind == OP_DIVMOD:
                _, a_terms, b_terms, n_int, q_idx, r_idx, limb_bits = op
                ka, kb = len(a_terms), len(b_terms)
                nw = -(-n_int.bit_length() // 64)
                noff = pool_put(n_int, nw)
                S = limb_bits * (ka + kb) + 2
                mu = (1 << S) // n_int
                muw = -(-mu.bit_length() // 64)
                muoff = pool_put(mu, muw)
                code += [9, limb_bits, ka, kb, len(q_idx), len(r_idx),
                         noff, nw, muoff, muw, S]
                for t in a_terms:
                    terms(t)
                for t in b_terms:
                    terms(t)
                code += list(q_idx)
                code += list(r_idx)
            elif kind == OP_SOLVE_AB:
                _, out, invc, Rrest, other, C, _ina = op
                code += [10, out, cid(invc), len(Rrest), len(other), len(C)]
                terms_at(Rrest)
                terms_at(other)
                terms_at(C)
            elif kind in (OP_NN_RED, OP_NN_QUOT):
                if kind == OP_NN_RED:
                    _, muls, lins, m_int, out_idx, limb_bits = op
                    bias = 0
                else:
                    _, muls, lins, m_int, bias, out_idx, limb_bits = op
                nw = -(-m_int.bit_length() // 64)
                moff = pool_put(m_int, nw)
                # Barrett shift sized to the max |total| bit-length:
                # sum of k^2 products of limb_bits-bit limb vectors
                kmax = max(
                    [len(a) for _s, a, _b in muls]
                    + [len(c) for _t, c in lins] + [1]
                )
                S = 2 * limb_bits * kmax + 64
                mu = (1 << S) // m_int
                muw = -(-mu.bit_length() // 64)
                muoff = pool_put(mu, muw)
                bw = max(1, -(-int(bias).bit_length() // 64))
                boff = pool_put(int(bias), bw)
                code += [11 if kind == OP_NN_RED else 12, limb_bits,
                         len(out_idx), moff, nw, muoff, muw, S, boff, bw,
                         len(muls), len(lins)]
                code += list(out_idx)
                for s, a, b in muls:
                    code += [1 if s >= 0 else 0, abs(s), len(a), len(b)]
                    for t in a:
                        terms(t)
                    for t in b:
                        terms(t)
                for t_c, c in lins:
                    code += [1 if t_c >= 0 else 0, abs(t_c), len(c)]
                    for t in c:
                        terms(t)
            elif kind == OP_NN_INV_MUL:
                _, nt, dt, m_int, out_idx, limb_bits = op
                nw = -(-m_int.bit_length() // 64)
                moff = pool_put(m_int, nw)
                kmax = max(
                    [len(c) for _t, c in nt] + [len(c) for _t, c in dt] + [1]
                )
                S = 2 * max(limb_bits * kmax, m_int.bit_length()) + 64
                mu = (1 << S) // m_int
                muw = -(-mu.bit_length() // 64)
                muoff = pool_put(mu, muw)
                code += [13, limb_bits, len(out_idx), moff, nw, muoff, muw,
                         S, len(nt), len(dt)]
                code += list(out_idx)
                for t_c, c in nt:
                    code += [1 if t_c >= 0 else 0, abs(t_c), len(c)]
                    for t in c:
                        terms(t)
                for t_c, c in dt:
                    code += [1 if t_c >= 0 else 0, abs(t_c), len(c)]
                    for t in c:
                        terms(t)
            else:
                raise CompileError(f"cannot serialize op kind {kind}")

        ncoeff = len(coeff_ids)
        ctab = np.zeros((ncoeff, 4), dtype="<u8")
        Rm = 1 << 256
        for c, i in coeff_ids.items():
            cm = (c * Rm) % F  # Montgomery form
            for w in range(4):
                ctab[i, w] = (cm >> (64 * w)) & 0xFFFFFFFFFFFFFFFF
        self._ser = (
            np.asarray(code, dtype=np.uint32),
            ctab,
            np.asarray(bigpool if bigpool else [0], dtype="<u8"),
        )
        return self._ser

    def run_native(self, prover_inputs: dict):
        """Native replay -> (nv, 4) u64 standard-form assignment.  The native
        backend is required: without it this raises."""
        from ..native import backend as nb

        if not nb.available():
            raise RuntimeError("the native host backend (crescent_tpu_torch/native) "
                               "is required and did not build")
        import numpy as np

        code, ctab, pool = self.serialize()
        idxs: list[int] = []
        vals: list[int] = []
        for ii, vv in self.input_vector(prover_inputs):
            idxs.extend(ii)
            vals.extend(v % self.field for v in vv)
        in_idx = np.asarray(idxs, dtype=np.uint32)
        in_val = nb.ints_to_u64(vals)
        return nb.witness_run(self.field, code, ctab, pool, in_idx, in_val,
                              self.num_vars)


def _pow2_log(c: int) -> int | None:
    if c > 0 and (c & (c - 1)) == 0:
        return c.bit_length() - 1
    return None


def compile_witness_program(r1cs, hints=None, input_wires=None) -> WitnessProgram:
    """Compile (R1CS, hints, input marks) into a WitnessProgram.

    `hints`/`input_wires` default to the `_hints`/`_input_wires` the builder
    attaches to the R1CS (ConstraintSystem.to_r1cs)."""
    F = r1cs.field
    nv = r1cs.num_vars
    hints = r1cs._hints if hints is None else hints
    input_wires = r1cs._input_wires if input_wires is None else input_wires

    known = bytearray(nv)
    known[0] = 1
    for _, idxs in input_wires:
        for i in idxs:
            known[i] = 1

    ops: list = []

    def require_known(terms, what):
        for i, _ in terms:
            if not known[i]:
                raise CompileError(f"{what}: input wire {i} unknown")

    def emit_hint(kind, payload):
        if kind == "decomp":
            terms, base, nbits = payload
            require_known(terms, "decomp hint")
            ops.append((OP_HINT_DECOMP, terms, base, nbits))
            for i in range(nbits):
                known[base + i] = 1
        elif kind == "inv01":
            terms, inv_i, out_i = payload
            require_known(terms, "inv01 hint")
            ops.append((OP_INV01, terms, inv_i, out_i))
            known[inv_i] = known[out_i] = 1
        elif kind == "onehot":
            terms, base, n = payload
            require_known(terms, "onehot hint")
            ops.append((OP_ONEHOT, terms, base, n))
            for j in range(n):
                known[base + j] = 1
        elif kind == "shr":
            terms, out, k = payload
            require_known(terms, "shr hint")
            ops.append((OP_SHR, terms, out, k))
            known[out] = 1
        elif kind == "negmod":
            terms, out, k = payload
            require_known(terms, "negmod hint")
            ops.append((OP_NEGMOD, terms, out, k))
            known[out] = 1
        elif kind == "sshr_bias":
            terms, out, k, bias = payload
            require_known(terms, "sshr_bias hint")
            ops.append((OP_SSHR_BIAS, terms, out, k, bias))
            known[out] = 1
        elif kind == "divmod":
            a_terms, b_terms, n_int, q_idx, r_idx, limb_bits = payload
            for t in a_terms:
                require_known(t, "divmod hint a")
            for t in b_terms:
                require_known(t, "divmod hint b")
            ops.append((OP_DIVMOD, a_terms, b_terms, n_int,
                        list(q_idx), list(r_idx), limb_bits))
            for i in list(q_idx) + list(r_idx):
                known[i] = 1
        elif kind in ("nn_red", "nn_quot"):
            if kind == "nn_red":
                muls, lins, m_int, out_idx, limb_bits = payload
            else:
                muls, lins, m_int, bias, out_idx, limb_bits = payload
            for _s, a, b in muls:
                for t in a:
                    require_known(t, f"{kind} hint mul a")
                for t in b:
                    require_known(t, f"{kind} hint mul b")
            for _t, c in lins:
                for t in c:
                    require_known(t, f"{kind} hint lin")
            if kind == "nn_red":
                ops.append((OP_NN_RED, muls, lins, m_int, list(out_idx),
                            limb_bits))
            else:
                ops.append((OP_NN_QUOT, muls, lins, m_int, bias,
                            list(out_idx), limb_bits))
            for i in out_idx:
                known[i] = 1
        elif kind == "nn_inv_mul":
            nt, dt, m_int, out_idx, limb_bits = payload
            for _t, c in nt:
                for t in c:
                    require_known(t, "nn_inv_mul num")
            for _t, c in dt:
                for t in c:
                    require_known(t, "nn_inv_mul den")
            ops.append((OP_NN_INV_MUL, nt, dt, m_int, list(out_idx),
                        limb_bits))
            for i in out_idx:
                known[i] = 1
        else:
            raise CompileError(f"unknown hint kind {kind}")

    hi = 0
    nh = len(hints)
    for t, (arow, brow, crow) in enumerate(r1cs.constraints):
        while hi < nh and hints[hi][0] <= t:
            emit_hint(hints[hi][1], hints[hi][2])
            hi += 1
        unknowns = {i for i, _ in arow if not known[i]}
        unknowns |= {i for i, _ in brow if not known[i]}
        unknowns |= {i for i, _ in crow if not known[i]}
        if not unknowns:
            continue
        if len(unknowns) == 1:
            u = next(iter(unknowns))
            in_a = any(i == u for i, _ in arow)
            in_b = any(i == u for i, _ in brow)
            in_c = any(i == u for i, _ in crow)
            if in_c and not in_a and not in_b:
                cu = next(c for i, c in crow if i == u)
                crest = [(i, c) for i, c in crow if i != u]
                invc = pow(cu % F, -1, F)
                if not crest and brow == [(0, 1)]:
                    # pure linear: out = evalA * invc (common add_const_mul)
                    ops.append((OP_SOLVE_LIN, u, invc, arow))
                else:
                    ops.append((OP_SOLVE_C, u, invc, arow, brow, crest))
                known[u] = 1
                continue
            if (in_a != in_b) and not in_c:
                row = arow if in_a else brow
                other = brow if in_a else arow
                cu = next(c for i, c in row if i == u)
                rrest = [(i, c) for i, c in row if i != u]
                invc = pow(cu % F, -1, F)
                ops.append((OP_SOLVE_AB, u, invc, rrest, other, crow, in_a))
                known[u] = 1
                continue
            # single unknown but in an unsupported position (e.g. a bit
            # self-constraint x*x = x): defer to a later pattern
            continue
        # multi-unknown: power-of-two decomposition over the A row of a
        # linear constraint  (A * 1 = 0)
        if brow == [(0, 1)] and not crow:
            unk = [(i, c % F) for i, c in arow if not known[i]]
            if {i for i, _ in unk} == unknowns:
                logs = [_pow2_log(c) for _, c in unk]
                neg = False
                if any(l is None for l in logs):
                    logs = [_pow2_log(F - c) for _, c in unk]
                    neg = True
                if all(l is not None for l in logs) and len(set(logs)) == len(logs):
                    pairs = sorted(zip(logs, (i for i, _ in unk)))
                    shifts = [k for k, _ in pairs]
                    outs = [i for _, i in pairs]
                    widths = [
                        (shifts[j + 1] - shifts[j]) for j in range(len(shifts) - 1)
                    ] + [260 - shifts[-1]]
                    kn = [(i, c) for i, c in arow if known[i]]
                    ops.append((OP_DECOMP, outs, shifts, widths, neg, kn))
                    for i in outs:
                        known[i] = 1
                    continue
        # unsupported; leave unknown — reported at the end if never solved
        continue
    while hi < nh:
        emit_hint(hints[hi][1], hints[hi][2])
        hi += 1

    unsolved = [i for i in range(nv) if not known[i]]
    if unsolved:
        raise CompileError(
            f"{len(unsolved)} wires not derivable; first 10: {unsolved[:10]}"
        )
    return WitnessProgram(F, nv, ops, list(input_wires))
