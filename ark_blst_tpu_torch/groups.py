"""The arkworks curve group classes: G1/G2 affine and projective, G2Prepared.

The port's counterpart of the JAX package's `groups.py`, class for class
and name for name: affine + projective newtypes with the operator matrix,
ZCash-format serialization with compress/validate modes, cofactor ops,
validation (on-curve and torsion-free) and `VariableBaseMSM`-style `msm`
(ark-blst src/g1.rs:602-632), which runs the card's bucket MSM
(`msm_g1` / `msm_g2`) by default and the host Pippenger on request.

`G2Prepared` is a first-class reusable object (ark-blst src/g2.rs:650-694)
whose serialization is implemented (the reference `todo!()`s it).

Value semantics: affine points are oracle tuples (`None` = identity);
projective classes share the same canonical value (the API contract is
value-level equality). Single-element ops run on host ints; `msm` moves
its batch through the host codecs (`ops/convert.py`) to the card and back.
"""

from __future__ import annotations

from .device import resolve_device
from .fields import Fp, Fp2, Scalar
from .ops import convert as CV
from .oracle import curve as OC
from .oracle import field as OF
from .oracle import serialize as OS


class _PointBase:
    """Shared machinery for the four point classes. Subclasses bind:
    _ops (oracle field-op bundle), _gen, _cofactor, _compressed_size,
    _uncompressed_size, serializers, and the coordinate wrapper type."""

    __slots__ = ("p",)

    def __init__(self, value=None):
        self.p = self._canon(value)

    @classmethod
    def _canon(cls, value):
        if value is None:
            return None
        if isinstance(value, _PointBase):
            return value.p
        x, y = value
        return (cls._coord_canon(x), cls._coord_canon(y))

    # -- constructors --

    @classmethod
    def zero(cls):
        return cls(None)

    identity = zero

    @classmethod
    def generator(cls):
        return cls(cls._gen)

    @classmethod
    def rand(cls, rng):
        """Uniform group element: k * G for uniform k (the reference samples
        the same way via `UniformRand`)."""
        return cls(OC.group_mul(cls._ops, cls._gen, rng.randrange(1, OF.R)))

    # -- predicates --

    def is_zero(self):
        return self.p is None

    is_identity = is_zero

    def is_on_curve(self):
        return OC.is_on_curve(self._ops, self.p)

    def is_in_correct_subgroup_assuming_on_curve(self):
        return OC.is_in_subgroup(self._ops, self.p)

    def check(self):
        """Full validation (= `Valid::check`, ark-blst src/g1.rs:386-396)."""
        if not self.is_on_curve():
            raise ValueError("point not on curve")
        if not self.is_in_correct_subgroup_assuming_on_curve():
            raise ValueError("point not in r-torsion subgroup")

    # -- accessors (owned xy(), per the patched arkworks the reference pins,
    #    ark-blst Cargo.toml:60-62, usage src/g1.rs:310-316) --

    def xy(self):
        if self.p is None:
            return None
        return (self._coord_wrap(self.p[0]), self._coord_wrap(self.p[1]))

    @property
    def x(self):
        return None if self.p is None else self._coord_wrap(self.p[0])

    @property
    def y(self):
        return None if self.p is None else self._coord_wrap(self.p[1])

    # -- group ops --

    def __add__(self, other):
        return self._projective(OC.group_add(self._ops, self.p, self._other(other)))

    def __sub__(self, other):
        return self + (-other)

    def __neg__(self):
        return type(self)(OC.group_neg(self._ops, self.p))

    def double(self):
        return self._projective(OC.group_double(self._ops, self.p))

    def mul(self, scalar):
        """Scalar multiplication (Scalar or int), -> projective."""
        k = scalar.v if isinstance(scalar, Scalar) else int(scalar)
        return self._projective(OC.group_mul(self._ops, self.p, k % OF.R))

    __mul__ = mul
    __rmul__ = mul

    def mul_bigint(self, k: int):
        """Unreduced-integer multiplication (= `mul_bigint`,
        ark-blst src/g1.rs:513-527 — no mod-r reduction)."""
        return self._projective(OC.group_mul(self._ops, self.p, int(k)))

    # -- cofactor ops (ark-blst src/g1.rs:343-355) --

    def mul_by_cofactor_to_group(self):
        return self._projective(OC.group_mul(self._ops, self.p, self._cofactor))

    def clear_cofactor(self):
        return type(self)(OC.group_mul(self._ops, self.p, self._cofactor))

    def mul_by_cofactor(self):
        return type(self)(OC.group_mul(self._ops, self.p, self._cofactor))

    def mul_by_cofactor_inv(self):
        """Multiply by COFACTOR_INV = cofactor^-1 mod r (G1:
        ark-blst src/g1.rs:49-52; G2: src/g2.rs:56-58)."""
        return type(self)(OC.group_mul(self._ops, self.p, self._cofactor_inv))

    def _other(self, other):
        if isinstance(other, _PointBase):
            return other.p
        raise TypeError(f"cannot add {type(other).__name__}")

    def __eq__(self, other):
        return isinstance(other, _PointBase) and self._ops is other._ops and self.p == other.p

    def __hash__(self):
        return hash((self._name, self.serialize()))

    def __repr__(self):
        return f"{self._name}({self.p!r})"

    # -- serialization (ZCash/blst formats, ark-blst src/g1.rs:358-431) --

    def serialize(self, compress: bool = True) -> bytes:
        return self._compress(self.p) if compress else self._uncompress(self.p)

    def serialize_compressed(self) -> bytes:
        return self.serialize(True)

    def serialize_uncompressed(self) -> bytes:
        return self.serialize(False)

    @classmethod
    def serialized_size(cls, compress: bool = True) -> int:
        return cls._compressed_size if compress else cls._uncompressed_size

    @classmethod
    def deserialize(cls, data: bytes, compress: bool = True, validate: bool = True):
        data = bytes(data)
        if compress:
            return cls(cls._decompress(data, validate))
        return cls(cls._from_uncompressed(data, validate))

    @classmethod
    def deserialize_compressed(cls, data: bytes, validate: bool = True):
        return cls.deserialize(data, True, validate)

    @classmethod
    def deserialize_uncompressed(cls, data: bytes, validate: bool = True):
        return cls.deserialize(data, False, validate)


class _ProjectiveMixin:
    """Projective-side extras: VariableBaseMSM + batch normalization."""

    def into_affine(self):
        return self._affine_cls(self.p)

    to_affine = into_affine

    @classmethod
    def from_affine(cls, aff):
        return cls(aff.p)

    @classmethod
    def batch_check(cls, points) -> None:
        """Batch validation (= `Valid::batch_check` on the projective types,
        ark-blst src/g1.rs:565-580): normalize the batch, then run
        the full on-curve + subgroup check on every element; raises
        ValueError on the first invalid point."""
        for aff in cls.batch_normalize(points):
            aff.check()

    @classmethod
    def batch_normalize(cls, points):
        """Projective batch -> affine batch (= `normalize_batch`,
        ark-blst src/g1.rs:537-543). Host path (values are affine
        already); the device twin is `curves.group.CurveOps.to_affine`."""
        return [cls._affine_cls(p.p) for p in points]

    @classmethod
    def msm(cls, bases, scalars, backend: str | None = None, c: int = 8,
            lanes: int = 128, maybe_abort=None, *, device="cuda"):
        """Variable-base MSM (= `VariableBaseMSM::msm`,
        ark-blst src/g1.rs:602-632). `bases` are affine or projective
        points, `scalars` Scalar/int. Identity inputs are fine (blst's
        Pippenger mishandles them, src/g1.rs:682-689).

        backend: "device" or None (the card's bucket MSM, `msm_g1` /
        `msm_g2`, on `device`), or "host" (the windowed Pippenger on host
        ints, `oracle.curve.msm_pippenger`). `c` must be >= 2; the device
        route clamps it to the bucket kernels' window (7 for G1, 5 for G2,
        the windows they were measured at). `lanes` is ignored, as on the
        JAX package's TPU route. `maybe_abort`, polled before every chunk
        of the device route, raises `MsmAborted` when it answers true."""
        if len(bases) != len(scalars):
            raise ValueError(f"{len(bases)} bases but {len(scalars)} scalars")
        if c < 2:
            raise ValueError(f"MSM window c must be >= 2, got {c}")
        ss = [s.v if isinstance(s, Scalar) else int(s) % OF.R for s in scalars]
        pts = [b.p for b in bases]
        if backend == "host":
            return cls(OC.msm_pippenger(cls._ops, pts, ss))
        if backend not in (None, "device"):
            raise ValueError(f"unknown MSM backend {backend!r}")
        dev = resolve_device(device)
        if not pts:
            return cls(None)

        # the package's __init__ holds the entries and imports this module
        from . import msm_g1, msm_g2
        from .curves.msm_bucket import KC2_G1, KC2_G2

        if cls._ops is OC.FP_OPS:
            entry, kc, to_dev, back = msm_g1, KC2_G1, CV.g1_to_dev, CV.g1_from_dev
        else:
            entry, kc, to_dev, back = msm_g2, KC2_G2, CV.g2_to_dev, CV.g2_from_dev
        out = entry(to_dev(pts), CV.fr_to_dev(ss), device=dev, c=min(c, kc.c_default),
                    maybe_abort=maybe_abort)
        return cls(back(out)[0])


# --- G1 ------------------------------------------------------------------------

class G1Affine(_PointBase):
    """Mirrors ark-blst src/g1.rs G1Affine."""

    _name = "G1Affine"
    _ops = OC.FP_OPS
    _gen = OF.G1_GEN
    _cofactor = OF.H_G1
    _cofactor_inv = OF.H_G1_INV_MOD_R
    _compressed_size = 48
    _uncompressed_size = 96
    _coord_wrap = Fp
    _coord_canon = staticmethod(Fp._canon)
    _compress = staticmethod(OS.g1_compress)
    _uncompress = staticmethod(OS.g1_uncompressed)
    _decompress = staticmethod(OS.g1_decompress)
    _from_uncompressed = staticmethod(OS.g1_from_uncompressed)

    COFACTOR = OF.H_G1

    def _projective(self, p):
        return G1Projective(p)


class G1Projective(_ProjectiveMixin, _PointBase):
    """Mirrors ark-blst src/g1.rs G1Projective (+ VariableBaseMSM)."""

    _name = "G1Projective"
    _ops = G1Affine._ops
    _gen = G1Affine._gen
    _cofactor = G1Affine._cofactor
    _cofactor_inv = G1Affine._cofactor_inv
    _compressed_size = 48
    _uncompressed_size = 96
    _coord_wrap = Fp
    _coord_canon = staticmethod(Fp._canon)
    _compress = staticmethod(OS.g1_compress)
    _uncompress = staticmethod(OS.g1_uncompressed)
    _decompress = staticmethod(OS.g1_decompress)
    _from_uncompressed = staticmethod(OS.g1_from_uncompressed)

    COFACTOR = OF.H_G1
    NEGATION_IS_CHEAP = True  # ark-blst src/g1.rs:593-600

    def _projective(self, p):
        return G1Projective(p)


G1Affine._affine_cls = G1Affine
G1Projective._affine_cls = G1Affine


# --- G2 ------------------------------------------------------------------------

class G2Affine(_PointBase):
    """Mirrors ark-blst src/g2.rs G2Affine."""

    _name = "G2Affine"
    _ops = OC.FP2_OPS
    _gen = OF.G2_GEN
    _cofactor = OF.H_G2
    _cofactor_inv = OF.H_G2_INV_MOD_R
    _compressed_size = 96
    _uncompressed_size = 192
    _coord_wrap = Fp2
    _coord_canon = staticmethod(Fp2._canon)
    _compress = staticmethod(OS.g2_compress)
    _uncompress = staticmethod(OS.g2_uncompressed)
    _decompress = staticmethod(OS.g2_decompress)
    _from_uncompressed = staticmethod(OS.g2_from_uncompressed)

    COFACTOR = OF.H_G2

    def _projective(self, p):
        return G2Projective(p)


class G2Projective(_ProjectiveMixin, _PointBase):
    """Mirrors ark-blst src/g2.rs G2Projective."""

    _name = "G2Projective"
    _ops = G2Affine._ops
    _gen = G2Affine._gen
    _cofactor = G2Affine._cofactor
    _cofactor_inv = G2Affine._cofactor_inv
    _compressed_size = 96
    _uncompressed_size = 192
    _coord_wrap = Fp2
    _coord_canon = staticmethod(Fp2._canon)
    _compress = staticmethod(OS.g2_compress)
    _uncompress = staticmethod(OS.g2_uncompressed)
    _decompress = staticmethod(OS.g2_decompress)
    _from_uncompressed = staticmethod(OS.g2_from_uncompressed)

    COFACTOR = OF.H_G2
    NEGATION_IS_CHEAP = True

    def _projective(self, p):
        return G2Projective(p)


G2Affine._affine_cls = G2Affine
G2Projective._affine_cls = G2Affine


# --- G2Prepared ----------------------------------------------------------------

class G2Prepared:
    """Precomputed Miller-loop line coefficients for a G2 point — the
    first-class reusable object of ark-blst src/g2.rs:650-694.

    `coeffs` is the 68-triple schedule (None for the identity, whose pairing
    contribution is substituted by one, src/pairing.rs:58-60). Unlike the
    reference (serialization `todo!()`, src/g2.rs:696-726), serialization is
    implemented: a 1-byte identity flag then the raw Fp2 triples."""

    __slots__ = ("coeffs",)

    NUM_COEFFS = 68  # 63 doublings + 5 additions for BLS12-381's x

    def __init__(self, coeffs):
        self.coeffs = coeffs

    @classmethod
    def from_affine(cls, q: G2Affine):
        from .oracle import pairing as OP

        return cls(OP.prepare_g2(q.p))

    @classmethod
    def from_projective(cls, q: G2Projective):
        return cls.from_affine(q.into_affine())

    @classmethod
    def default(cls):
        """Prepared generator (= `Default`, ark-blst src/g2.rs:660-664)."""
        return cls.from_affine(G2Affine.generator())

    def is_identity(self) -> bool:
        return self.coeffs is None

    def __eq__(self, other):
        return isinstance(other, G2Prepared) and self.coeffs == other.coeffs

    def serialize(self, compress: bool = True) -> bytes:
        if self.coeffs is None:
            return b"\x01"
        out = [b"\x00"]
        for c0, c1, c2 in self.coeffs:
            out += [OS.fp2_to_bytes(c0), OS.fp2_to_bytes(c1), OS.fp2_to_bytes(c2)]
        return b"".join(out)

    @classmethod
    def deserialize(cls, data: bytes, compress: bool = True, validate: bool = True):
        data = bytes(data)
        if not data:
            raise ValueError("empty G2Prepared input")
        # the JAX package reads any first byte other than 1 as "not the
        # identity"; the port accepts only the two flags it writes
        if data[0] not in (0, 1):
            raise ValueError(f"bad G2Prepared identity flag {data[0]}")
        if data[0] == 1:
            return cls(None)
        need = 1 + cls.NUM_COEFFS * 3 * 96
        if len(data) < need:
            raise ValueError("short G2Prepared input")
        coeffs = []
        ofs = 1
        for _ in range(cls.NUM_COEFFS):
            triple = []
            for _ in range(3):
                triple.append(OS.fp2_from_bytes(data[ofs : ofs + 96]))
                ofs += 96
            coeffs.append(tuple(triple))
        return cls(coeffs)

    @classmethod
    def serialized_size(cls, compress: bool = True) -> int:
        return 1 + cls.NUM_COEFFS * 3 * 96
