"""The port's lazy RCB15 group law (curves/lazy_group.py) against the JAX
package's (ark_blst_tpu/curves/lazy_group.py), digit for digit, and against
the host oracle by value, on a batch that holds the completeness edge cases
(identity, doubling through the addition, inverse pairs): over Fp (G1,
`FP_LAZY`) and over Fp2 (G2, `FP2_LAZY`), whose field layer
(ops/lazy13.py `fp2_*`) is held against the JAX engine's here too."""

import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from ark_blst_tpu.curves import lazy_group as JLG
from ark_blst_tpu.ops import lazy13 as JLZ
from ark_blst_tpu_torch.curves import lazy_group as LG
from ark_blst_tpu_torch.ops import lazy13 as LZ
from ark_blst_tpu_torch.oracle import curve as OC
from ark_blst_tpu_torch.oracle import field as OF
from ark_blst_tpu_torch.oracle.field import G1_GEN, G2_GEN, P


@pytest.fixture(autouse=True, scope="module")
def _share_cpu_among_workers():
    """One torch thread per core in every pytest-xdist worker oversubscribes
    the machine and slows this module's tests about tenfold: split the cores
    among the workers while the module runs."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    prev = torch.get_num_threads()
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(prev)


RINV = pow(LZ.R13, -1, P)


def enc(vals):
    """ints mod p -> balanced lazy elements (30, n) in the R13 domain, the
    form ingest and the buckets store."""
    mat = np.stack([LZ.int_to_digits(v * LZ.R13 % P) for v in vals]).T
    return LZ.store30(torch.from_numpy(mat))


def jx(t):
    return [jnp.asarray(row) for row in t.numpy()]


def same(port_pt, jax_pt):
    for pc, jc in zip(port_pt, jax_pt):
        want = np.stack([np.asarray(x) for x in jc])
        assert (pc.numpy() == want).all()


def to_affine(pt):
    xs, ys, zs = (LZ.digits_to_ints(c) for c in pt)
    out = []
    for x, y, z in zip(xs, ys, zs):
        z = z * RINV % P
        if z == 0:
            out.append(None)
        else:
            zi = pow(z, -1, P)
            out.append((x * RINV * zi % P, y * RINV * zi % P))
    return out


def _cases():
    """(p1 affine or None, p2 affine) pairs of the edge cases and random ones."""
    g = [OC.scalar_mul(G1_GEN, k) for k in (5, 7, 11, 13, 29, 1234567)]
    return [
        (None, g[0]),  # identity + b
        (g[0], g[0]),  # doubling through the complete addition
        (g[0], OC.neg(g[0])),  # b + (-b)
        (g[1], g[2]),
        (g[3], g[4]),
        (g[5], g[1]),
        (g[2], g[5]),
        (None, g[3]),
    ]


def _proj(pts):
    xs = [0 if p is None else p[0] for p in pts]
    ys = [1 if p is None else p[1] for p in pts]
    zs = [0 if p is None else 1 for p in pts]
    return (enc(xs), enc(ys), enc(zs))


def test_mixed_add():
    cases = _cases()
    p1 = _proj([a for a, _ in cases])
    p2 = (enc([b[0] for _, b in cases]), enc([b[1] for _, b in cases]))
    got = LG.mixed_add(LG.FP_LAZY, p1, p2)
    want = JLG.mixed_add(JLG.FP_LAZY, tuple(jx(c) for c in p1), tuple(jx(c) for c in p2))
    same(got, want)
    assert to_affine(got) == [OC.add(a, b) for a, b in cases]


@pytest.mark.parametrize("op", ["full_add", "double"])
def test_full_add_and_double_on_redundant_inputs(op):
    cases = _cases()
    p1 = _proj([a for a, _ in cases])
    p2 = (enc([b[0] for _, b in cases]), enc([b[1] for _, b in cases]))
    q = LG.mixed_add(LG.FP_LAZY, p1, p2)  # redundant projective, Z != 1
    r = _proj([b for _, b in reversed(cases)])
    jq, jr = tuple(jx(c) for c in q), tuple(jx(c) for c in r)
    sums = [OC.add(a, b) for a, b in cases]
    if op == "full_add":
        got = LG.full_add(LG.FP_LAZY, q, r)
        same(got, JLG.full_add(JLG.FP_LAZY, jq, jr))
        want = [OC.add(s, b) for s, (_, b) in zip(sums, reversed(cases))]
    else:
        got = LG.double(LG.FP_LAZY, q)
        same(got, JLG.double(JLG.FP_LAZY, jq))
        want = [OC.double(s) for s in sums]
    assert to_affine(got) == want


# --- G2: the Fp2 layer and FP2_LAZY --------------------------------------------

F = LZ.F_BOUND


def fp2_digits(seed, n=16):
    """A random mul-ready Fp2 batch with the extreme patterns in the first
    columns: +-F_BOUND, alternating signs, and re and im of opposite signs."""
    rng = np.random.default_rng(seed)
    a = rng.integers(-F, F + 1, (2, 30, n)).astype(np.int32)
    a[:, :, 0], a[:, :, 1] = F, -F
    a[:, :, 2] = [F if k % 2 else -F for k in range(30)]
    a[0, :, 3], a[1, :, 3] = F, -F
    return (torch.from_numpy(a[0]), torch.from_numpy(a[1]))


def jx2(pair):
    return (jx(pair[0]), jx(pair[1]))


def same_tree(port, jax_tree):
    """Nested tuples of stacked tensors against the same nesting of JAX
    digit lists, leaf for leaf."""
    if isinstance(port, tuple):
        assert len(port) == len(jax_tree)
        for p, j in zip(port, jax_tree):
            same_tree(p, j)
        return
    want = np.stack([np.asarray(x) for x in jax_tree])
    assert port.shape == want.shape and (port.numpy() == want).all()


@pytest.mark.parametrize("op", ["add", "sub", "neg", "scale", "fold_sum", "select",
                                "mul_prered", "reduce", "mont_mul"])
def test_fp2_ops_match_jax(op):
    a, b = fp2_digits(1), fp2_digits(2)
    mask = torch.from_numpy(np.arange(a[0].shape[1]) % 3 == 0)
    port, jaxf = getattr(LZ, "fp2_" + op), getattr(JLZ, "fp2_" + op)
    if op in ("add", "sub", "mul_prered", "mont_mul"):
        got, want = port(a, b), jaxf(jx2(a), jx2(b))
    elif op in ("neg", "fold_sum"):
        got, want = port(a), jaxf(jx2(a))
    elif op == "scale":
        got, want = port(a, 12), jaxf(jx2(a), 12)
    elif op == "select":
        got, want = port(mask, a, b), jaxf(jnp.asarray(mask.numpy()), jx2(a), jx2(b))
    else:  # reduce: a round-2 combination of two products, 6 prered wides in im
        w = LZ.fp2_add(LZ.fp2_mul_prered(a, b), LZ.fp2_mul_prered(b, a))
        jw = JLZ.fp2_add(JLZ.fp2_mul_prered(jx2(a), jx2(b)), JLZ.fp2_mul_prered(jx2(b), jx2(a)))
        same_tree(w, jw)
        got, want = port(w), jaxf(jw)
    same_tree(got, want)


def enc2(vals):
    return (enc([v[0] for v in vals]), enc([v[1] for v in vals]))


def _proj2(pts):
    xs = [OF.FP2_ZERO if p is None else p[0] for p in pts]
    ys = [OF.FP2_ONE if p is None else p[1] for p in pts]
    zs = [OF.FP2_ZERO if p is None else OF.FP2_ONE for p in pts]
    return (enc2(xs), enc2(ys), enc2(zs))


def to_affine2(pt):
    def vals(coord):
        re, im = (LZ.digits_to_ints(c) for c in coord)
        return [(a * RINV % P, b * RINV % P) for a, b in zip(re, im)]

    out = []
    for x, y, z in zip(*(vals(c) for c in pt)):
        if z == OF.FP2_ZERO:
            out.append(None)
        else:
            zi = OF.fp2_inv(z)
            out.append((OF.fp2_mul(x, zi), OF.fp2_mul(y, zi)))
    return out


def _cases2():
    g = [OC.g2_mul(G2_GEN, k) for k in (5, 7, 11, 13, 29, 1234567)]
    return [(None, g[0]), (g[0], g[0]), (g[0], OC.g2_neg(g[0])), (g[1], g[2]),
            (g[3], g[4]), (g[5], g[1]), (None, g[3])]


@pytest.mark.parametrize("op", ["mixed_add", "full_add", "double"])
def test_g2_group_law_matches_jax(op):
    """mixed_add on the edge cases; full_add and double on the redundant
    projective sums it returns (Z != 1)."""
    cases = _cases2()
    p1 = _proj2([a for a, _ in cases])
    p2 = (enc2([b[0] for _, b in cases]), enc2([b[1] for _, b in cases]))
    jp1, jp2 = tuple(jx2(c) for c in p1), tuple(jx2(c) for c in p2)
    q = LG.mixed_add(LG.FP2_LAZY, p1, p2)
    sums = [OC.g2_add(a, b) for a, b in cases]
    if op == "mixed_add":
        same_tree(q, JLG.mixed_add(JLG.FP2_LAZY, jp1, jp2))
        assert to_affine2(q) == sums
        return
    jq = tuple(jx2(c) for c in q)
    if op == "full_add":
        r = _proj2([b for _, b in reversed(cases)])
        got = LG.full_add(LG.FP2_LAZY, q, r)
        same_tree(got, JLG.full_add(JLG.FP2_LAZY, jq, tuple(jx2(c) for c in r)))
        want = [OC.g2_add(s, b) for s, (_, b) in zip(sums, reversed(cases))]
    else:
        got = LG.double(LG.FP2_LAZY, q)
        same_tree(got, JLG.double(JLG.FP2_LAZY, jq))
        want = [OC.g2_double(s) for s in sums]
    assert to_affine2(got) == want


def test_fp2_adapter_constants_match_jax():
    like = fp2_digits(3)
    same_tree(LG.FP2_LAZY.one(like), JLG.FP2_LAZY.one(jx2(like)))
    same_tree(LG.FP2_LAZY.zero(like), JLG.FP2_LAZY.zero(jx2(like)))
    same_tree(LG.FP2_LAZY.mul_b3(like), JLG.FP2_LAZY.mul_b3(jx2(like)))
    same_tree(LG.FP2_LAZY.store30(like), JLG.FP2_LAZY.store30(jx2(like)))
