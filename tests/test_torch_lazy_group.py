"""The port's lazy RCB15 group law (curves/lazy_group.py) against the JAX
package's (ark_blst_tpu/curves/lazy_group.py), digit for digit, and against
the host oracle by value, on a batch that holds the completeness edge cases
(identity, doubling through the addition, inverse pairs)."""

import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from ark_blst_tpu.curves import lazy_group as JLG
from ark_blst_tpu_torch.curves import lazy_group as LG
from ark_blst_tpu_torch.ops import lazy13 as LZ
from ark_blst_tpu_torch.oracle import curve as OC
from ark_blst_tpu_torch.oracle.field import G1_GEN, P


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
