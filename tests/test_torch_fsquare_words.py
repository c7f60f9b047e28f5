"""A model of fsquare_chain_kernel's 8 x 32-bit arithmetic
(tendermint_tpu_torch/csrc/fe25519_w32.cuh), held against x^(2^k) mod p,
the port's plain chain and the JAX package's square chain.

Every PTX carry chain of the header (w32_add19, the row chains of w32_mac,
the sum of the cross products, the squares, the two halves of the x38
reduction, freeze's subtraction of p) runs from the header's own text: each
`asm volatile` block is read from the file, its operands bound by its
constraint list, and its instructions run on an interpreter with one carry
flag, as PTX has. The C++ between the blocks (the pack of 20 carried
radix-2^13 limbs with the x19 fold of the bits from 2^255 up, the rows'
first products, the doubling by funnel shifts, the folds, the final select
and the unpack to canonical limbs) is modelled in Python integers. An `addc`
or `madc.hi` without carry out, where the kernel drops the carry, raises if
the sum needs one: the edges and the all-ones words (the largest partial
sums of every chain) check that each chain's carry stops where the kernel
ends it.

Inputs: seeded carried limbs (limb 0 <= 2^13 + 607, the others <= 2^13),
the largest carried limbs, the values 0, 1, p - 1, p, p + 1, 2^255 - 1 and
values whose packed sum crosses 2^256; k = 1, 2, 10, 50 and 100; and a
hypothesis property over random carried limbs. Tolerance: exact (integers;
the model's output must be canonical limbs).
"""

import os
import re

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from tendermint_tpu.ops import fe25519 as jfe
from tendermint_tpu_torch.ops import cuda_fe
from tendermint_tpu_torch.ops import fe25519 as tfe

P = 2**255 - 19
M32 = (1 << 32) - 1
KS = (1, 2, 10, 50, 100)
LIMB0_MAX, LIMB_MAX = (1 << 13) + 607, 1 << 13
HEADER = os.path.join(cuda_fe.CSRC, "fe25519_w32.cuh")
# the header's asm blocks, by (function, ordinal in the function)
EXPECTED_BLOCKS = (("w32_add19", 0), ("w32_mac", 0), ("w32_mac", 1), ("w32_mac", 2),
                   ("w32_square", 0), ("w32_square", 1), ("w32_square", 2),
                   ("w32_square", 3), ("w32_freeze", 0))


def _split_top(text, sep):
    """`text` split at each `sep` outside string literals and brackets."""
    parts, depth, quoted, cur, i = [], 0, False, "", 0
    while i < len(text):
        ch = text[i]
        if quoted:
            cur += ch
            if ch == "\\":
                cur += text[i + 1]
                i += 1
            elif ch == '"':
                quoted = False
        elif ch == '"':
            quoted, cur = True, cur + ch
        elif ch in "([":
            depth, cur = depth + 1, cur + ch
        elif ch in ")]":
            depth, cur = depth - 1, cur + ch
        elif ch == sep and depth == 0:
            parts.append(cur)
            cur = ""
        else:
            cur += ch
        i += 1
    return parts + [cur]


def asm_blocks(text):
    """{(function, ordinal): (instructions, [(constraint, expr)] outputs,
    [(constraint, expr)] inputs)} for every `asm volatile(...)` in `text`."""
    blocks, counts = {}, {}
    for m in re.finditer(r"asm volatile\(", text):
        depth, i = 1, m.end()
        while depth:
            depth += {"(": 1, ")": -1}.get(text[i], 0)
            i += 1
        body = text[m.end():i - 1]
        fn = re.findall(r"void (w32_\w+)\(", text[:m.start()])[-1]
        template, outs, ins = _split_top(body, ":")
        lines = "".join(re.findall(r'"((?:[^"\\]|\\.)*)"', template))
        instrs = [x.strip() for x in lines.replace("\\n", "\n").replace("\\t", "").split("\n")
                  if x.strip()]
        operands = [[(c, e.strip()) for c, e in re.findall(r'"([+=]?\w)"\(([^()]*)\)', part)]
                    for part in (outs, ins)]
        key = (fn, counts.get(fn, 0))
        counts[fn] = key[1] + 1
        blocks[key] = (instrs, *operands)
    return blocks


with open(HEADER) as _f:
    BLOCKS = asm_blocks(_f.read())
INSTR = re.compile(r"(add|addc|mad|madc)(\.lo|\.hi)?(\.cc)?\.u32 (.*);")


def _compiled(key):
    """Block `key` as (instructions (op, half, cc, dst, srcs), code that
    reads its operands, code that writes its outputs), built once."""
    if key not in _COMPILED:
        instrs, outs, ins = BLOCKS[key]
        exprs = [re.sub(r"\b(\d+)u\b", r"\1", e) for _, e in outs + ins]
        steps = []
        for line in instrs:
            m = INSTR.fullmatch(line)
            assert m, line
            base, half, cc, args = m.groups()
            d, *src = [a.strip() for a in args.split(",")]
            steps.append((base, half, bool(cc), int(d[1:]),
                          [(True, int(a[1:])) if a.startswith("%") else (False, int(a, 0))
                           for a in src], line))
        read = compile("[" + ", ".join(exprs) + "]", key[0], "eval")
        write = compile("\n".join(f"{e} = _v[{k}]" for k, e in enumerate(exprs[:len(outs)])),
                        key[0], "exec")
        _COMPILED[key] = steps, read, write
    return _COMPILED[key]


_COMPILED = {}


def run(key, env):
    """Runs the header's asm block `key` on `env` (the C++ names it binds:
    lists and ints) with one carry flag, and writes its outputs back."""
    steps, read, write = _compiled(key)
    ops = eval(read, {}, env)
    cf = 0
    for base, half, cc, d, src, line in steps:
        v = [ops[x] if reg else x for reg, x in src]
        if base in ("add", "addc"):
            s = v[0] + v[1]
        else:
            p = v[0] * v[1]
            s = (p & M32 if half == ".lo" else p >> 32) + v[2]
        if base in ("addc", "madc"):
            s += cf
        if cc:
            cf = s >> 32
        elif s >> 32:  # the chain's end: the kernel drops the carry, so there is none
            raise OverflowError(f"carry out of a chain's last word: {key} {line}")
        ops[d] = s & M32
    exec(write, {}, {**env, "_v": ops})


def value(words):
    return sum(w << (32 * i) for i, w in enumerate(words))


def add19(w, top):
    """w32_add19: W + 19 top on one chain from word 0."""
    run(("w32_add19", 0), {"w": w, "top": top})


def pack(limbs):
    """w32_pack: limb i at bit 13 i of a 64-bit window that emits a word
    once no later limb reaches below its top; then the 19-fold of bit 255 up."""
    w, acc = [0] * 8, 0
    for i, x in enumerate(limbs):
        acc += x << ((13 * i) % 32)
        assert acc < 1 << 64
        if (13 * (i + 1)) // 32 > (13 * i) // 32:
            w[(13 * i) // 32] = acc & M32
            acc >>= 32
    top = ((acc << 1) & M32) | (w[7] >> 31)
    w[7] &= 0x7FFFFFFF
    add19(w, top)
    return w


def row(acc, a, i, j, first):
    """w32_row<I, J, FIRST>: the products a_i a_j, j = J, J + 2, ... <= 7;
    a later row on w32_mac<N, I + J>'s chain."""
    js = list(range(j, 8, 2))
    if first:
        for jj in js:
            acc[i + jj] = a[i] * a[jj] & M32
            acc[i + jj + 1] = a[i] * a[jj] >> 32
        return
    n = (7 - j) // 2 + 1
    assert n == len(js) and 1 <= n <= 3
    b = [a[jj] if jj < 8 else a[j] for jj in (j, j + 2, j + 4)]
    run(("w32_mac", n - 1), {"acc": acc, "B": i + j, "a": a[i], "b0": b[0], "b1": b[1],
                             "b2": b[2]})


def shl1(lo, hi):
    """__funnelshift_l(lo, hi, 1)."""
    return ((hi << 1) | (lo >> 31)) & M32


def square(a):
    """w32_square: a^2 (mod p), lazily; returns the new words and T, the
    512-bit square before its reduction."""
    e, o = [0] * 16, [0] * 16
    row(e, a, 0, 1, True)
    row(o, a, 0, 2, True)
    for i in range(1, 7):
        row(e, a, i, i + 1, False)
        if i + 2 <= 7:
            row(o, a, i, i + 2, False)
    assert o[15] == 0 and o[0] == o[1] == 0 and e[0] == 0
    run(("w32_square", 0), {"e": e, "o": o})  # C = e + o
    t = [a[0] * a[0] & M32, (e[1] << 1) & M32] + [shl1(e[k - 1], e[k]) for k in range(2, 16)]
    run(("w32_square", 1), {"t": t, "a": a})  # T = 2 C + the squares
    r = t[:8] + [0]
    run(("w32_square", 2), {"r": r, "t": t})  # R = T_lo + 38 lo(T_hi)
    run(("w32_square", 3), {"r": r, "t": t})  # ... + 38 hi(T_hi)
    top = ((r[8] << 1) & M32) | (r[7] >> 31)
    w = r[:7] + [r[7] & 0x7FFFFFFF]
    add19(w, top)
    return w, value(t)


def freeze(w):
    """w32_freeze: fold bit 255, then subtract p where W + 19 reaches 2^255."""
    w = list(w)
    top = w[7] >> 31
    w[7] &= 0x7FFFFFFF
    add19(w, top)
    u = list(w)
    run(("w32_freeze", 0), {"u": u})
    if u[7] >> 31:
        w = u
    w[7] &= 0x7FFFFFFF
    return w


def unpack(w):
    """w32_unpack: canonical words -> 20 limbs of 13 bits."""
    out = []
    for i in range(20):
        q, s = (13 * i) // 32, (13 * i) % 32
        v = w[q] >> s
        if s > 19 and q < 7:
            v |= (w[q + 1] << (32 - s)) & M32
        out.append(v & 0x1FFF)
    return out


def model(limbs, k):
    """fsquare_chain_kernel on one lane, checking each step's bound."""
    w = pack(limbs)
    assert value(w) < 2**255 + 19 * 63
    assert value(w) % P == sum(x << (13 * i) for i, x in enumerate(limbs)) % P
    for _ in range(k):
        before = value(w)
        w, t = square(w)
        assert t == before * before
        assert value(w) < 2**255 + 19 * 77 and value(w) % P == t % P
    return unpack(freeze(w))


def limbs_of(v):
    """The 13-bit limbs of an integer below 2^260 (not reduced mod p)."""
    assert 0 <= v < 1 << 260
    return [(v >> (13 * i)) & 0x1FFF for i in range(20)]


def from_limbs(limbs):
    return sum(int(x) << (13 * i) for i, x in enumerate(limbs))


EDGES = {
    "max carried limbs": [LIMB0_MAX] + [LIMB_MAX] * 19,
    "0": limbs_of(0),
    "1": limbs_of(1),
    "p - 1": limbs_of(P - 1),
    "p": limbs_of(P),
    "p + 1": limbs_of(P + 1),
    "2^255 - 1": limbs_of(2**255 - 1),
    # packed sums at and across 2^256: bit 256 set with a full low part, and
    # the largest 13-bit limbs (2^260 - 1)
    "2^256 + 2^255 - 1": limbs_of(2**256 + 2**255 - 1),
    "2^256": limbs_of(2**256),
    "2^260 - 1": limbs_of(2**260 - 1),
    "every limb 2^13": [LIMB_MAX] * 20,
}


def seeded(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, LIMB_MAX + 1, size=(n, 20))
    x[:, 0] = rng.integers(0, LIMB0_MAX + 1, size=n)
    x[: n // 4] = np.where(rng.random((n // 4, 20)) < 0.5, LIMB_MAX, x[: n // 4])
    return [list(map(int, r)) for r in x]


def canonical(limbs):
    return all(0 <= x < 1 << 13 for x in limbs) and from_limbs(limbs) < P


def test_model_runs_every_asm_block_of_the_header():
    """The header's carry chains are the nine asm blocks the model runs, each
    with its operands numbered within its constraint list."""
    assert tuple(BLOCKS) == EXPECTED_BLOCKS
    for key, (instrs, outs, ins) in BLOCKS.items():
        used = {int(x) for line in instrs for x in re.findall(r"%(\d+)", line)}
        assert used == set(range(len(outs) + len(ins))), key
        assert all(c == "+r" for c, _ in outs) and all(c == "r" for c, _ in ins), key


def _words(rng, n, top_bits=32, ripple=False):
    """n words: all ones (every carry ripples) or seeded; the last word
    below 2^top_bits."""
    w = [M32] * n if ripple else [int(x) for x in rng.integers(0, 1 << 32, size=n)]
    w[-1] &= (1 << top_bits) - 1
    return w


def _block_case(key, rng, ripple):
    """(env for the header's asm block `key`, the value its words must hold
    after it, a function of env giving that value) on seeded or all-ones
    words, each within the bound the kernel gives the block."""
    if key == ("w32_add19", 0):
        w = _words(rng, 8, 31, ripple)
        top = 77 if ripple else int(rng.integers(0, 78))
        return {"w": w, "top": top}, value(w) + 19 * top, lambda env: value(env["w"])
    if key[0] == "w32_mac":
        n, base = key[1] + 1, 1
        acc = [0] * 16
        acc[base:base + 2 * n + 1] = _words(rng, 2 * n + 1, 30, ripple)
        a, *b = _words(rng, 4, 32, ripple)
        want = value(acc) + a * sum(b[m] << (64 * m) for m in range(n)) * (1 << (32 * base))
        return ({"acc": acc, "B": base, "a": a, "b0": b[0], "b1": b[1], "b2": b[2]}, want,
                lambda env: value(env["acc"]))
    if key == ("w32_square", 0):  # C = e + o
        e, o = [0] * 16, [0] * 16
        e[2:16] = _words(rng, 14, 30, ripple)
        o[2:15] = _words(rng, 13, 32, ripple)
        return {"e": e, "o": o}, value(e) + value(o), lambda env: value(env["e"])
    if key == ("w32_square", 1):  # T = 2 C + the squares (t[0] is set outside)
        t = [0] + _words(rng, 15, 30, ripple)
        a = _words(rng, 8, 31, ripple)
        want = value(t) + sum(x * x << (64 * i) for i, x in enumerate(a)) - (a[0] * a[0] & M32)
        return {"t": t, "a": a}, want, lambda env: value(env["t"])
    if key == ("w32_square", 2):  # R = T_lo + 38 lo(T_hi)
        t = _words(rng, 16, 32, ripple)
        want = value(t[:8]) + sum((38 * t[8 + k] & M32) << (32 * k) for k in range(8))
        return {"r": t[:8] + [0], "t": t}, want, lambda env: value(env["r"])
    if key == ("w32_square", 3):  # ... + 38 hi(T_hi)
        t = _words(rng, 16, 32, ripple)
        r = _words(rng, 8, 32, ripple) + [int(rng.integers(0, 2))]
        want = value(r) + sum((38 * t[8 + k] >> 32) << (32 * (k + 1)) for k in range(8))
        return {"r": r, "t": t}, want, lambda env: value(env["r"])
    assert key == ("w32_freeze", 0)
    u = _words(rng, 8, 31, ripple)
    return {"u": u}, value(u) + 19, lambda env: value(env["u"])


@pytest.mark.parametrize("key", EXPECTED_BLOCKS, ids=lambda k: f"{k[0]}-{k[1]}")
def test_each_asm_block_adds_what_its_chain_states(key):
    """Each carry chain of the header, alone, on all-ones words (a carry out
    of every instruction but the last) and on seeded words: its words hold
    the integer sum it states, and its last instruction needs no carry out."""
    rng = np.random.default_rng(sum(map(ord, key[0])) + key[1])
    for ripple in (True,) + (False,) * 200:
        env, want, got = _block_case(key, rng, ripple)
        run(key, env)
        assert got(env) == want, (key, ripple)


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("edge", list(EDGES))
def test_model_equals_pow_at_edges(edge, k):
    limbs = EDGES[edge]
    got = model(limbs, k)
    assert canonical(got)
    assert from_limbs(got) == pow(from_limbs(limbs), 1 << k, P)


def test_every_chain_carry_stops_at_its_last_word():
    """The all-ones words give every chain its largest partial sums; a
    squaring of them raises if any chain needed a carry past its end."""
    a = [M32] * 8
    w, t = square(a)
    assert t == value(a) ** 2
    assert value(w) % P == t % P and value(w) < 2**256
    # and the largest words the squarings hand on (W < 2^255 + 19 x 77)
    big = 2**255 + 19 * 77 - 1
    w, t = square([(big >> (32 * i)) & M32 for i in range(8)])
    assert t == big * big and value(w) % P == t % P


@pytest.mark.parametrize("k", KS)
def test_model_equals_plain_and_jax_chains(k):
    """Seeded carried limbs and the edges through the model, the port's plain
    chain (frozen) and the JAX package's square chain on the CPU (frozen):
    all give x^(2^k) mod p in the same canonical limbs."""
    cases = list(EDGES.values()) + seeded(24, 100 + k)  # every edge is carried limbs
    x = np.array(cases, dtype=np.int32).T.copy()  # (20, lanes)
    got = np.array([model(c, k) for c in cases], dtype=np.int64).T
    plain = tfe.freeze(cuda_fe.fsquare_chain_plain(torch.from_numpy(x), k)).numpy()
    jax_chain = np.asarray(jfe.freeze(jfe._pow2k(x, k)))
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_array_equal(got, jax_chain)
    for j, c in enumerate(cases):
        assert from_limbs(got[:, j]) == pow(from_limbs(c), 1 << k, P)


@settings(max_examples=150, deadline=None)
@given(limb0=st.integers(0, LIMB0_MAX), rest=st.lists(st.integers(0, LIMB_MAX), min_size=19,
                                                        max_size=19),
       k=st.sampled_from(KS))
def test_model_property_random_carried_limbs(limb0, rest, k):
    limbs = [limb0] + rest
    got = model(limbs, k)
    assert canonical(got)
    assert from_limbs(got) == pow(from_limbs(limbs), 1 << k, P)
