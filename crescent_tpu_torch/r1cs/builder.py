"""Native R1CS statement builder with integrated witness computation.

This is the framework's replacement for the circom + wasmer witness stack
(forks/circom-compat; SURVEY.md §7.3 "later, compile the constraint graph"):
gadgets add constraints AND compute the concrete wire values in one pass, so
"synthesize" with inputs yields the full assignment, and the same code run
with placeholder inputs yields the circuit shape for setup (gadget control
flow must therefore be data-independent).

Wire layout follows circom convention: [1, public_outputs..., public_inputs...,
private...] — so IOLocations positions transfer unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..core.fields import BN254_FR

R = BN254_FR  # default field (circom circuits); ConstraintSystem(field=...) overrides


@dataclass(frozen=True)
class Var:
    idx: int


class LC:
    """Sparse linear combination over wires."""

    __slots__ = ("terms",)

    def __init__(self, terms=None):
        self.terms: dict[int, int] = dict(terms or {})

    @staticmethod
    def of(v, coeff: int = 1) -> "LC":
        if isinstance(v, LC):
            return v if coeff == 1 else v.scale(coeff)
        if isinstance(v, Var):
            return LC({v.idx: coeff})
        return LC({0: v * coeff})  # constant

    def __add__(self, o):
        if not isinstance(o, LC):
            o = LC.of(o)
        t = dict(self.terms)
        for k, c in o.terms.items():
            t[k] = t.get(k, 0) + c
        return LC(t)

    def __sub__(self, o):
        if not isinstance(o, LC):
            o = LC.of(o)
        t = dict(self.terms)
        for k, c in o.terms.items():
            t[k] = t.get(k, 0) - c
        return LC(t)

    def scale(self, k: int) -> "LC":
        return LC({i: c * k for i, c in self.terms.items()})

    def to_list(self, modulus: int = None) -> list:
        # insertion order (deterministic); consumers are order-independent
        if modulus is None:
            modulus = R
        out = []
        for i, c in self.terms.items():
            c %= modulus
            if c:
                out.append((i, c))
        return out


class ConstraintSystem:
    """Builder + witness calculator in one pass.

    Witness-replay hints: gadget-level value computations that cannot be
    re-derived by constraint-directed solving (bit decompositions, modular
    inverses, bigint quotients, one-hot indicators, ...) are recorded in
    ``self.hints`` as ``(pos, kind, payload)`` where ``pos`` is the number
    of constraints emitted when the hint was recorded (the witness program
    executes a hint before the constraint at index ``pos``).  Together with
    ``mark_input``, this lets r1cs/witness_program.py compile the finished
    system into a replayable witness program so repeat proves skip Python
    gadget execution entirely (round-5 perf item 2b)."""

    def __init__(self, field: int = R):
        self.F = field
        self.values: list[int] = [1]
        self.constraints: list = []
        self.n_pub_out = 0
        self.n_pub_in = 0
        self._frozen_publics = False
        self.io_names: dict[str, int] = {}  # name -> wire position (IOLocations)
        self.hints: list = []               # (pos, kind, payload...)
        self.input_wires: list = []         # (name, [wire idx, ...])

    # -- allocation ---------------------------------------------------------
    def alloc(self, value: int) -> Var:
        """Private witness wire."""
        self._frozen_publics = True
        self.values.append(value % self.F)
        return Var(len(self.values) - 1)

    def alloc_public(self, value: int, name: str | None = None, is_output: bool = True) -> Var:
        """Public IO wire; must be allocated before any private wire."""
        assert not self._frozen_publics, "allocate publics before privates"
        self.values.append(value % self.F)
        idx = len(self.values) - 1
        if is_output:
            self.n_pub_out += 1
        else:
            self.n_pub_in += 1
        if name:
            self.io_names[name] = idx
        return Var(idx)

    # -- constraint emission -----------------------------------------------
    def enforce(self, a: LC, b: LC, c: LC):
        self.constraints.append(
            (a.to_list(self.F), b.to_list(self.F), c.to_list(self.F))
        )

    def value(self, x) -> int:
        if isinstance(x, Var):
            return self.values[x.idx]
        if isinstance(x, LC):
            return sum(self.values[i] * c for i, c in x.terms.items()) % self.F
        return x % self.F

    # -- gadget library -----------------------------------------------------
    def mul(self, a, b) -> Var:
        """out = a * b."""
        if isinstance(a, Var) and isinstance(b, Var):
            vals = self.values
            out = self.alloc(vals[a.idx] * vals[b.idx] % self.F)
            self.constraints.append(([(a.idx, 1)], [(b.idx, 1)], [(out.idx, 1)]))
            return out
        va, vb = self.value(a), self.value(b)
        out = self.alloc(va * vb % self.F)
        self.enforce(LC.of(a), LC.of(b), LC.of(out))
        return out

    def add_const_mul(self, lc: LC) -> Var:
        """Materialize an LC into a wire (one constraint: lc * 1 = out)."""
        out = self.alloc(self.value(lc))
        self.enforce(lc, LC.of(1), LC.of(out))
        return out

    def assert_equal(self, a, b):
        self.enforce(LC.of(a) - LC.of(b), LC.of(1), LC.of(0))

    def assert_bool(self, x):
        """x * (x - 1) = 0."""
        if isinstance(x, Var):  # raw fast path (hottest constraint kind)
            self.constraints.append(
                ([(x.idx, 1)], [(x.idx, 1), (0, self.F - 1)], [])
            )
            return
        self.enforce(LC.of(x), LC.of(x) - LC.of(1), LC.of(0))

    def alloc_bool(self, value: int) -> Var:
        v = self.alloc(value & 1)
        self.assert_bool(v)
        return v

    def decompose_bits(self, x, nbits: int) -> list[Var]:
        """Little-endian bit decomposition with recomposition constraint
        (circomlib Num2Bits semantics)."""
        val = self.value(x)
        vals = self.values
        cons = self.constraints
        F = self.F
        self._frozen_publics = True
        base = len(vals)
        self._hint("decomp", LC.of(x).to_list(F), base, nbits)
        acc = []
        for i in range(nbits):
            idx = base + i
            vals.append((val >> i) & 1)
            cons.append(([(idx, 1)], [(idx, 1), (0, F - 1)], []))
            acc.append((idx, 1 << i))
        if isinstance(x, Var) and x.idx >= base:  # can't alias fresh bits
            raise AssertionError
        xl = LC.of(x, -1).to_list(F)
        cons.append((acc + xl, [(0, 1)], []))
        return [Var(base + i) for i in range(nbits)]

    def bits_to_num(self, bits: list[Var]) -> Var:
        out = self.alloc(
            sum(self.values[b.idx] << i for i, b in enumerate(bits)) % self.F
        )
        acc = [(b.idx, 1 << i) for i, b in enumerate(bits)]
        self.constraints.append((acc, [(0, 1)], [(out.idx, 1)]))
        return out

    def xor(self, a: Var, b: Var) -> Var:
        """Boolean XOR: out = a + b - 2ab."""
        vals = self.values
        out = self.alloc(vals[a.idx] ^ vals[b.idx])
        # a*2b = a + b - out
        F = self.F
        if a.idx != b.idx:
            c = [(a.idx, 1), (b.idx, 1), (out.idx, F - 1)]
        else:
            c = [(a.idx, 2), (out.idx, F - 1)]
        self.constraints.append(([(a.idx, 2)], [(b.idx, 1)], c))
        return out

    def and_(self, a: Var, b: Var) -> Var:
        if isinstance(a, Var) and isinstance(b, Var):
            vals = self.values
            out = self.alloc(vals[a.idx] * vals[b.idx] % self.F)
            self.constraints.append(([(a.idx, 1)], [(b.idx, 1)], [(out.idx, 1)]))
            return out
        return self.mul(a, b)

    def not_(self, a: Var) -> LC:
        return LC.of(1) - LC.of(a)

    def select(self, cond: Var, a, b) -> Var:
        """cond ? a : b  =  b + cond*(a-b)."""
        vc = self.value(cond)
        out = self.alloc(self.value(a) if vc else self.value(b))
        self.enforce(LC.of(cond), LC.of(a) - LC.of(b), LC.of(out) - LC.of(b))
        return out

    def is_zero(self, x) -> Var:
        """1 if x == 0 else 0 (circomlib IsZero)."""
        vx = self.value(x)
        inv = self.alloc(pow(vx, -1, self.F) if vx else 0)
        out = self.alloc(0 if vx else 1)
        self._hint("inv01", LC.of(x).to_list(self.F), inv.idx, out.idx)
        # out = 1 - x*inv ; x*out = 0
        self.enforce(LC.of(x), LC.of(inv), LC.of(1) - LC.of(out))
        self.enforce(LC.of(x), LC.of(out), LC.of(0))
        return out

    # -- witness-replay hint plumbing ---------------------------------------
    def _hint(self, kind: str, *payload):
        self.hints.append((len(self.constraints), kind, payload))

    def mark_input(self, vars, name: str):
        """Declare wires whose values come from prover inputs (not derivable
        by constraint solving).  `vars` is a Var or list of Vars; replay
        feeds them from an input dict keyed by `name` (list of ints)."""
        if isinstance(vars, Var):
            vars = [vars]
        self.input_wires.append((name, [v.idx for v in vars]))

    def one_hot(self, x, n: int) -> list[Var]:
        """Allocate an n-wide one-hot indicator for value(x) (no constraints
        — the caller emits them, e.g. jwt_circuit.point_indicator)."""
        xv = self.value(x)
        base = len(self.values)
        out = [self.alloc(1 if j == xv else 0) for j in range(n)]
        self._hint("onehot", LC.of(x).to_list(self.F), base, n)
        return out

    def alloc_shr(self, x, k: int) -> Var:
        """Allocate value(x) >> k (exact floor-div by 2^k; the caller
        constrains it)."""
        out = self.alloc(self.value(x) >> k)
        self._hint("shr", LC.of(x).to_list(self.F), out.idx, k)
        return out

    def alloc_negmod_pow2(self, x, k: int) -> Var:
        """Allocate (-value(x)) mod 2^k."""
        out = self.alloc((-self.value(x)) % (1 << k))
        self._hint("negmod", LC.of(x).to_list(self.F), out.idx, k)
        return out

    def alloc_sshr_bias(self, lc, k: int, bias: int) -> Var:
        """Allocate ((signed_lift(value(lc)) >> k) + bias) mod F, where
        signed_lift maps residues > F/2 to their negative representatives.
        Used for biased carry witnesses in bigint gadgets."""
        v = self.value(lc)
        if v > self.F // 2:
            v -= self.F
        out = self.alloc((( v >> k) + bias) % self.F)
        self._hint("sshr_bias", LC.of(lc).to_list(self.F), out.idx, k, bias)
        return out

    def hint_divmod(self, a_limbs, b_limbs, n_int: int, q_idx: list[int],
                    r_idx: list[int], limb_bits: int):
        """Record: (A*B) divmod n_int -> q/r limbs, where A/B are little-
        endian limb vectors of wires (each limb an LC/Var/const)."""
        F = self.F
        a_terms = [LC.of(l).to_list(F) for l in a_limbs]
        b_terms = [LC.of(l).to_list(F) for l in b_limbs]
        self._hint("divmod", a_terms, b_terms, n_int, tuple(q_idx),
                   tuple(r_idx), limb_bits)

    # -- non-native (limb-vector) hints: r1cs/p256.py emulated arithmetic ---
    def _nn_terms(self, muls, lins):
        """muls: [(s, a_limbs, b_limbs)], lins: [(t, c_limbs)] with limbs
        Var/LC/int — serialize to term lists for replay."""
        F = self.F
        ms = [
            (int(s), [LC.of(l).to_list(F) for l in a],
             [LC.of(l).to_list(F) for l in b])
            for s, a, b in muls
        ]
        ls = [(int(t), [LC.of(l).to_list(F) for l in c]) for t, c in lins]
        return ms, ls

    def hint_nn_red(self, muls, lins, m_int: int, out_idx: list[int],
                    limb_bits: int):
        """out limbs <- (sum s*A*B + sum t*C) mod m_int (exact signed
        integer evaluation over limb vectors)."""
        ms, ls = self._nn_terms(muls, lins)
        self._hint("nn_red", ms, ls, m_int, tuple(out_idx), limb_bits)

    def hint_nn_quot(self, muls, lins, m_int: int, bias: int,
                     out_idx: list[int], limb_bits: int):
        """out limbs <- (sum s*A*B + sum t*C) // m_int + bias (floor
        division of the exact signed integer; bias makes it nonnegative)."""
        ms, ls = self._nn_terms(muls, lins)
        self._hint("nn_quot", ms, ls, m_int, int(bias), tuple(out_idx),
                   limb_bits)

    def hint_nn_inv_mul(self, num_lins, den_lins, m_int: int,
                        out_idx: list[int], limb_bits: int):
        """out limbs <- (NUM * DEN^-1) mod m_int with NUM/DEN signed linear
        combinations of limb vectors ([(t, c_limbs)], exact integers);
        DEN == 0 mod m maps to 0 (p256._inv0 semantics).  m_int prime."""
        F = self.F
        nt = [(int(t), [LC.of(l).to_list(F) for l in c]) for t, c in num_lins]
        dt = [(int(t), [LC.of(l).to_list(F) for l in c]) for t, c in den_lins]
        self._hint("nn_inv_mul", nt, dt, m_int, tuple(out_idx), limb_bits)

    # -- export -------------------------------------------------------------
    @property
    def num_instance(self) -> int:
        return 1 + self.n_pub_out + self.n_pub_in

    def to_r1cs(self):
        from ..models.groth16 import R1CS

        r = R1CS(
            num_instance=self.num_instance,
            num_witness=len(self.values) - self.num_instance,
            constraints=self.constraints,
            field=self.F,
        )
        # witness-replay metadata rides on the R1CS so the api layer can
        # compile a replay program (r1cs/witness_program.py) without keeping
        # the whole ConstraintSystem alive
        r._hints = self.hints
        r._input_wires = self.input_wires
        return r

    def assignment(self) -> list[int]:
        return list(self.values)

    def io_locations(self):
        from ..credentials.structs import IOLocations

        return IOLocations(dict(self.io_names))

    def is_satisfied(self) -> bool:
        return self.to_r1cs().is_satisfied(self.values)

    def write_r1cs(self, path: str):
        from .reader import write_r1cs

        write_r1cs(
            path,
            self.constraints,
            n_wires=len(self.values),
            n_pub_out=self.n_pub_out,
            n_pub_in=self.n_pub_in,
            n_prv_in=len(self.values) - self.num_instance,
        )
