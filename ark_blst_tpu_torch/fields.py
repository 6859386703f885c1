"""The arkworks field element classes: Fp, Scalar (Fr), Fp2, Fp6, Fp12 (Gt).

The port's counterpart of the JAX package's `fields.py`, class for class
and name for name: value semantics on canonical host ints (operators,
serialization, rand, hashing, Frobenius, sqrt/legendre, the sponge
surface), on the port's own oracle. Bulk work on the card goes through
the group classes' `msm` and the `Bls12` batch entries; these classes
carry single values.

Deliberate departures from the reference crate (ark-blst), kept as in the
JAX package:
* `frobenius_map` is correct for Fp2/Fp6/Fp12 (the reference's is a no-op,
  ark-blst src/fp2.rs:548, fp6.rs:552, fp12.rs:554).
* `Fp6.from_base_prime_field_elems` slices correctly (reference bug at
  ark-blst src/fp6.rs:490-493).
* FFT constants live on Scalar only (the reference's Fp FftField constants
  are placeholders, ark-blst src/fp.rs:476-492).

Byte formats are bit-exact with the reference: raw little-endian dumps,
`compress` ignored for fields (ark-blst src/fp.rs:258-273,
src/scalar.rs:245-260, src/fp2.rs:246-261, src/fp6.rs, src/fp12.rs).
"""

from __future__ import annotations

from .oracle import field as OF
from .oracle import serialize as OS


def _from_random_bytes_generic(modulus, modulus_bits, ser_bytes, data,
                               flag_bit_mask):
    """Arkworks `from_random_bytes_with_flags` semantics, shared by Fp/Fr.

    arkworks places the flag bits in byte `output_byte_size - 1` where
    `output_byte_size = ceil((MODULUS_BIT_SIZE + FLAG_BIT_SIZE) / 8)` — for
    a nonzero flag type that byte can sit one PAST the serialized size
    (e.g. Fr: 255 value bits + 2 flag bits -> byte 32 of a 33-byte buffer,
    with bit 254 kept in the value). Bits at/above MODULUS_BIT_SIZE are
    shaved from the value before the canonicality check (last-limb mask).
    Returns (int value, flags) or None (non-canonical / oversized input).
    """
    f = bin(flag_bit_mask).count("1")
    obs = (modulus_bits + f + 7) // 8  # arkworks output_byte_size
    if len(data) > obs:
        return None
    raw = bytearray(bytes(data).ljust(ser_bytes + 1, b"\x00"))
    flags = raw[obs - 1] & flag_bit_mask
    raw[obs - 1] &= 0xFF ^ flag_bit_mask
    top = modulus_bits % 8  # shave bits >= MODULUS_BIT_SIZE
    raw[ser_bytes - 1] &= (1 << top) - 1 if top else 0xFF
    v = int.from_bytes(bytes(raw[:ser_bytes]), "little")
    if v >= modulus:
        return None
    return v, flags


class _FieldElement:
    """Shared operator/serde plumbing. Subclasses define the value domain
    (`_wrap`/`_unwrap` canonical Python values) and the op table."""

    __slots__ = ("v",)

    # subclasses set: _add/_sub/_mul/_neg/_inv (static), _zero/_one values,
    # _nbytes, _name

    def __init__(self, value):
        self.v = self._canon(value)

    # -- construction helpers --

    @classmethod
    def zero(cls):
        return cls(cls._zero)

    @classmethod
    def one(cls):
        return cls(cls._one)

    def is_zero(self):
        return self.v == self._zero

    def is_one(self):
        return self.v == self._one

    # -- operators (the matrix at ark-blst src/fp.rs:54-196) --

    def __add__(self, other):
        return type(self)(self._add(self.v, self._coerce(other)))

    def __sub__(self, other):
        return type(self)(self._sub(self.v, self._coerce(other)))

    def __mul__(self, other):
        return type(self)(self._mul(self.v, self._coerce(other)))

    def __truediv__(self, other):
        o = self._coerce(other)
        return type(self)(self._mul(self.v, type(self)._inv(o)))

    def __neg__(self):
        return type(self)(self._neg(self.v))

    __radd__ = __add__
    __rmul__ = __mul__

    def __rsub__(self, other):
        return type(self)(self._sub(self._coerce(other), self.v))

    def __eq__(self, other):
        return isinstance(other, type(self)) and self.v == other.v

    def __hash__(self):
        # the reference hashes the LE byte serialization (src/fp.rs:221-225)
        return hash((self._name, self.serialize()))

    def __repr__(self):
        return f"{self._name}({self.v!r})"

    def __int__(self):
        """Canonical integer value — the `PrimeField::into_bigint` analog
        (ark-blst src/fp.rs:494-521); prime fields only."""
        if not isinstance(self.v, int):
            raise TypeError(f"{self._name} is not a prime field element")
        return self.v

    def _coerce(self, other):
        if isinstance(other, type(self)):
            return other.v
        if isinstance(other, int) and self._name in ("Fp", "Scalar"):
            return other % self._modulus
        raise TypeError(f"cannot coerce {type(other).__name__} to {self._name}")

    # -- arkworks Field surface --

    def double(self):
        return self + self

    def square(self):
        return self * self

    def inverse(self):
        """None for zero, like arkworks `Field::inverse`."""
        if self.is_zero():
            return None
        return type(self)(type(self)._inv(self.v))

    def pow(self, exponent: int):
        result = type(self).one()
        base = self
        e = exponent
        if e < 0:
            base = base.inverse()
            if base is None:
                raise ZeroDivisionError(
                    f"{self._name}: negative power of zero"
                )
            e = -e
        while e > 0:
            if e & 1:
                result = result * base
            base = base.square()
            e >>= 1
        return result

    def frobenius_map(self, power: int = 1):
        """Correct Frobenius x -> x^(p^power) (reference no-ops this —
        quirk ledger, ark-blst src/fp2.rs:548)."""
        return type(self)(self._frobenius(self.v, power))

    @classmethod
    def sum_of_products(cls, a, b):
        """sum_i a_i * b_i (role of ark-blst src/fp.rs:523-655's
        `sum_of_products`)."""
        out = cls.zero()
        for x, y in zip(a, b):
            out = out + x * y
        return out

    # -- serialization (raw LE; compress ignored, like the reference) --

    def serialize(self, compress: bool = True) -> bytes:
        return self._to_bytes(self.v)

    serialize_compressed = serialize
    serialize_uncompressed = serialize

    @classmethod
    def deserialize(cls, data: bytes, validate: bool = True):
        if len(data) < cls._nbytes:
            raise ValueError(f"short {cls._name} input: {len(data)} bytes")
        return cls(cls._from_bytes(bytes(data[: cls._nbytes])))

    deserialize_compressed = deserialize
    deserialize_uncompressed = deserialize

    @classmethod
    def serialized_size(cls, compress: bool = True) -> int:
        return cls._nbytes

    # -- randomness --

    @classmethod
    def rand(cls, rng):
        """Uniform element; `rng` is a `random.Random`-like object."""
        return cls(cls._rand_value(rng))


# --- Fp ------------------------------------------------------------------------

class Fp(_FieldElement):
    """Base field (381-bit). Mirrors ark-blst src/fp.rs."""

    _name = "Fp"
    _modulus = OF.P
    _zero, _one = 0, 1
    _nbytes = 48
    _add = staticmethod(OF.fp_add)
    _sub = staticmethod(OF.fp_sub)
    _mul = staticmethod(OF.fp_mul)
    _neg = staticmethod(OF.fp_neg)
    _inv = staticmethod(OF.fp_inv)
    _to_bytes = staticmethod(OS.fp_to_bytes)
    _from_bytes = staticmethod(OS.fp_from_bytes)

    MODULUS = OF.P
    EXTENSION_DEGREE = 1

    @staticmethod
    def _canon(value):
        if isinstance(value, Fp):
            return value.v
        return int(value) % OF.P

    @staticmethod
    def _frobenius(v, power):
        return v  # prime field: Frobenius is the identity (src/fp.rs:606)

    @staticmethod
    def _rand_value(rng):
        return rng.randrange(OF.P)

    def sqrt(self):
        """None if not a QR (arkworks `Field::sqrt` returning Option)."""
        s = OF.fp_sqrt(self.v)
        return None if s is None else Fp(min(s, OF.P - s))

    def legendre(self):
        """0 for zero, 1 for QR, -1 for non-QR (the reference leaves this
        unimplemented, ark-blst src/fp.rs:568-579)."""
        return OF.fp_legendre(self.v)

    @classmethod
    def from_le_bytes_mod_order(cls, data: bytes):
        return cls(int.from_bytes(data, "little") % OF.P)

    @classmethod
    def characteristic(cls):
        return OF.P

    def into_bigint(self) -> int:
        return self.v

    @classmethod
    def from_bigint(cls, v: int):
        """Exact BigInt conversion (= `From<BigInt<6>>`,
        ark-blst src/fp.rs:289-467): None if v >= p."""
        return cls(v) if 0 <= v < OF.P else None

    @classmethod
    def from_str(cls, s: str):
        """Decimal-string parse (= the reference's `FromStr`,
        ark-blst src/fp.rs:436-467): raises ValueError for values
        >= p or malformed input."""
        v = int(s, 10)
        if not 0 <= v < OF.P:
            raise ValueError("value out of range for Fp")
        return cls(v)

    @classmethod
    def from_random_bytes_with_flags(cls, data: bytes, flag_bit_mask: int = 0):
        """Arkworks generic-Fp semantics (the reference leaves this
        `unimplemented!()`, ark-blst src/fp.rs:568-579): flags read
        from arkworks' output_byte_size-1 position (byte 47 for <= 3 flag
        bits, byte 48 beyond), bits at/above MODULUS_BIT_SIZE (381) shaved,
        (Fp, flags) iff the remaining value is canonical. See
        `_from_random_bytes_generic` (the flag byte moves past the serialized
        size when modulus bits + flag bits > 8*48)."""
        out = _from_random_bytes_generic(OF.P, 381, 48, data, flag_bit_mask)
        return (cls(out[0]), out[1]) if out else None

    @classmethod
    def from_random_bytes(cls, data: bytes):
        out = cls.from_random_bytes_with_flags(data, 0)
        return out[0] if out else None


# --- Scalar (Fr) -----------------------------------------------------------------

class Scalar(_FieldElement):
    """Scalar field Fr (255-bit). Mirrors ark-blst src/scalar.rs,
    including the real FFT constants (src/scalar.rs:465-471) and the sponge
    `Absorb` surface (src/scalar.rs:661-671)."""

    _name = "Scalar"
    _modulus = OF.R
    _zero, _one = 0, 1
    _nbytes = 32
    _add = staticmethod(lambda a, b: (a + b) % OF.R)
    _sub = staticmethod(lambda a, b: (a - b) % OF.R)
    _mul = staticmethod(lambda a, b: (a * b) % OF.R)
    _neg = staticmethod(lambda a: (-a) % OF.R)
    _inv = staticmethod(lambda a: pow(a, -1, OF.R))
    _to_bytes = staticmethod(OS.scalar_to_bytes)
    _from_bytes = staticmethod(OS.scalar_from_bytes)

    MODULUS = OF.R
    EXTENSION_DEGREE = 1
    # FftField constants — ark-blst src/scalar.rs:465-471
    TWO_ADICITY = OF.FR_TWO_ADICITY

    @staticmethod
    def _canon(value):
        if isinstance(value, Scalar):
            return value.v
        return int(value) % OF.R

    @staticmethod
    def _frobenius(v, power):
        return v

    @staticmethod
    def _rand_value(rng):
        return rng.randrange(OF.R)

    def sqrt(self):
        """Tonelli–Shanks via the 2-adic root of unity."""
        if self.is_zero():
            return Scalar(0)
        if pow(self.v, (OF.R - 1) // 2, OF.R) != 1:
            return None
        # r - 1 = q * 2^s with q odd
        s = OF.FR_TWO_ADICITY
        q = (OF.R - 1) >> s
        z = OF.FR_ROOT_OF_UNITY
        m, c, t = s, z, pow(self.v, q, OF.R)
        res = pow(self.v, (q + 1) // 2, OF.R)
        while t != 1:
            i, t2 = 0, t
            while t2 != 1:
                t2 = t2 * t2 % OF.R
                i += 1
            b = pow(c, 1 << (m - i - 1), OF.R)
            m, c = i, b * b % OF.R
            t = t * c % OF.R
            res = res * b % OF.R
        return Scalar(min(res, OF.R - res))

    def legendre(self):
        if self.is_zero():
            return 0
        return 1 if pow(self.v, (OF.R - 1) // 2, OF.R) == 1 else -1

    @classmethod
    def from_le_bytes_mod_order(cls, data: bytes):
        return cls(int.from_bytes(data, "little") % OF.R)

    @classmethod
    def characteristic(cls):
        return OF.R

    def into_bigint(self) -> int:
        return self.v

    # -- sponge Absorb (mirrors ark-blst src/scalar.rs:661-671) --

    @classmethod
    def from_bigint(cls, v: int):
        """None if v >= r (mirrors arkworks' fallible BigInt conversion)."""
        return cls(v) if 0 <= v < OF.R else None

    @classmethod
    def from_str(cls, s: str):
        v = int(s, 10)
        if not 0 <= v < OF.R:
            raise ValueError("value out of range for Fr")
        return cls(v)

    @classmethod
    def from_random_bytes_with_flags(cls, data: bytes, flag_bit_mask: int = 0):
        """Arkworks `from_random_bytes_with_flags` semantics (the reference
        delegates to ark-bls12-381, ark-blst src/scalar.rs:553-560):
        flags read from arkworks' output_byte_size-1 position — byte 31 for
        empty flags, byte 32 of a 33-byte buffer for >= 2 flag bits (255
        modulus bits + flag bits > 256, with bit 254 kept in the value) —
        bits at/above MODULUS_BIT_SIZE (255) shaved, (Scalar, flags) iff
        the remaining value is canonical (< r). Empty input is Some(0).
        See `_from_random_bytes_generic`."""
        out = _from_random_bytes_generic(OF.R, 255, 32, data, flag_bit_mask)
        return (cls(out[0]), out[1]) if out else None

    @classmethod
    def from_random_bytes(cls, data: bytes):
        out = cls.from_random_bytes_with_flags(data, 0)
        return out[0] if out else None

    def to_sponge_bytes(self) -> bytes:
        """= serialize_compressed (the reference delegates exactly so)."""
        return self.serialize()

    def to_sponge_field_elements(self, target=None):
        """field_cast into `target` (default: same field). Returns a list.
        Raises for cross-characteristic casts, the reference's None case."""
        target = target or Scalar
        return [field_cast(self, target)]


def field_cast(x, target):
    """Re-interpret a prime-field element in another field of the SAME
    characteristic via LE bytes (mirrors `field_cast`,
    ark-blst src/scalar.rs:645-659)."""
    if type(x).characteristic() != target.characteristic():
        raise ValueError("trying to absorb non-native field elements")
    return target.from_le_bytes_mod_order(x.into_bigint().to_bytes(64, "little"))


# FftField constants (bound here, immediately after the class, so no code
# can observe a placeholder — ark-blst src/scalar.rs:465-471).
Scalar.GENERATOR = Scalar(OF.FR_GENERATOR)
Scalar.TWO_ADIC_ROOT_OF_UNITY = Scalar(OF.FR_ROOT_OF_UNITY)


# --- Fp2 ---------------------------------------------------------------------

class Fp2(_FieldElement):
    """Quadratic extension Fp[u]/(u^2+1). Mirrors ark-blst src/fp2.rs
    (with a working Frobenius)."""

    _name = "Fp2"
    _zero, _one = OF.FP2_ZERO, OF.FP2_ONE
    _nbytes = 96
    _add = staticmethod(OF.fp2_add)
    _sub = staticmethod(OF.fp2_sub)
    _mul = staticmethod(OF.fp2_mul)
    _neg = staticmethod(OF.fp2_neg)
    _inv = staticmethod(OF.fp2_inv)
    _to_bytes = staticmethod(OS.fp2_to_bytes)
    _from_bytes = staticmethod(OS.fp2_from_bytes)

    EXTENSION_DEGREE = 2

    @staticmethod
    def _canon(value):
        if isinstance(value, Fp2):
            return value.v
        c0, c1 = value
        return (Fp._canon(c0), Fp._canon(c1))

    @classmethod
    def new(cls, c0, c1):
        """Constructor parity with Fp2::new (ark-blst src/fp2.rs:450-454)."""
        return cls((c0, c1))

    @property
    def c0(self):
        return Fp(self.v[0])

    @property
    def c1(self):
        return Fp(self.v[1])

    @staticmethod
    def _frobenius(v, power):
        return OF.fp2_frobenius(v, power)

    @staticmethod
    def _rand_value(rng):
        return (rng.randrange(OF.P), rng.randrange(OF.P))

    def conjugate(self):
        return Fp2(OF.fp2_conj(self.v))

    def mul_by_nonresidue(self):
        return Fp2(OF.fp2_mul_by_nonresidue(self.v))

    def sqrt(self):
        s = OF.fp2_sqrt(self.v)
        return None if s is None else Fp2(s)

    def legendre(self):
        """Via the norm map to Fp."""
        if self.is_zero():
            return 0
        norm = (self.v[0] ** 2 + self.v[1] ** 2) % OF.P
        return OF.fp_legendre(norm)

    @classmethod
    def from_base_prime_field_elems(cls, elems):
        if len(elems) != 2:
            return None
        return cls((Fp._canon(elems[0]), Fp._canon(elems[1])))

    @classmethod
    def characteristic(cls):
        return OF.P


# --- Fp6 ---------------------------------------------------------------------

class Fp6(_FieldElement):
    """Cubic-over-quadratic extension Fp2[v]/(v^3 - (u+1)). Mirrors
    ark-blst src/fp6.rs — with from_base_prime_field_elems slicing
    FIXED (reference bug at src/fp6.rs:490-493)."""

    _name = "Fp6"
    _zero, _one = OF.FP6_ZERO, OF.FP6_ONE
    _nbytes = 288
    _add = staticmethod(OF.fp6_add)
    _sub = staticmethod(OF.fp6_sub)
    _mul = staticmethod(OF.fp6_mul)
    _neg = staticmethod(OF.fp6_neg)
    _inv = staticmethod(OF.fp6_inv)
    _to_bytes = staticmethod(OS.fp6_to_bytes)
    _from_bytes = staticmethod(OS.fp6_from_bytes)

    EXTENSION_DEGREE = 6

    @staticmethod
    def _canon(value):
        if isinstance(value, Fp6):
            return value.v
        a0, a1, a2 = value
        return (Fp2._canon(a0), Fp2._canon(a1), Fp2._canon(a2))

    @classmethod
    def new(cls, c0, c1, c2):
        return cls((c0, c1, c2))

    @property
    def c0(self):
        return Fp2(self.v[0])

    @property
    def c1(self):
        return Fp2(self.v[1])

    @property
    def c2(self):
        return Fp2(self.v[2])

    @staticmethod
    def _frobenius(v, power):
        return OF.fp6_frobenius(v, power)

    @staticmethod
    def _rand_value(rng):
        return tuple(Fp2._rand_value(rng) for _ in range(3))

    def mul_by_nonresidue(self):
        return Fp6(OF.fp6_mul_by_nonresidue(self.v))

    @classmethod
    def from_base_prime_field_elems(cls, elems):
        """Correct c0/c1/c2 slicing (the reference builds c1 and c2 from the
        same slice — ark-blst src/fp6.rs:490-493)."""
        if len(elems) != 6:
            return None
        pairs = [
            (Fp._canon(elems[2 * i]), Fp._canon(elems[2 * i + 1])) for i in range(3)
        ]
        return cls(tuple(pairs))

    @classmethod
    def characteristic(cls):
        return OF.P


# --- Fp12 / Gt -----------------------------------------------------------------

class Fp12(_FieldElement):
    """Tower top Fp6[w]/(w^2 - v), exported as `Gt`
    (ark-blst src/lib.rs:12). Implements the cyclotomic-subgroup
    surface (`CyclotomicMultSubgroup`, ark-blst src/pairing.rs:14-32)
    with a REAL cyclotomic inverse (the reference conjugates a temporary and
    discards it — src/pairing.rs:21)."""

    _name = "Fp12"
    _zero, _one = OF.FP12_ZERO, OF.FP12_ONE
    _nbytes = 576
    _add = staticmethod(OF.fp12_add)
    _sub = staticmethod(OF.fp12_sub)
    _mul = staticmethod(OF.fp12_mul)
    _neg = staticmethod(OF.fp12_neg)
    _inv = staticmethod(OF.fp12_inv)
    _to_bytes = staticmethod(OS.fp12_to_bytes)
    _from_bytes = staticmethod(OS.fp12_from_bytes)

    EXTENSION_DEGREE = 12
    INVERSE_IS_FAST = True  # cyclotomic inverse = conjugation

    @staticmethod
    def _canon(value):
        if isinstance(value, Fp12):
            return value.v
        b0, b1 = value
        return (Fp6._canon(b0), Fp6._canon(b1))

    @classmethod
    def new(cls, c0, c1):
        return cls((c0, c1))

    @property
    def c0(self):
        return Fp6(self.v[0])

    @property
    def c1(self):
        return Fp6(self.v[1])

    @staticmethod
    def _frobenius(v, power):
        return OF.fp12_frobenius(v, power)

    @staticmethod
    def _rand_value(rng):
        return tuple(Fp6._rand_value(rng) for _ in range(2))

    def conjugate(self):
        return Fp12(OF.fp12_conj(self.v))

    def cyclotomic_square(self):
        """Granger–Scott squaring; valid in the cyclotomic subgroup only
        (role of blst_fp12_cyclotomic_sqr, ark-blst src/pairing.rs:28)."""
        return Fp12(OF.fp12_cyclotomic_sqr(self.v))

    def cyclotomic_inverse(self):
        """Conjugation (INVERSE_IS_FAST) — actually returned, unlike the
        reference's discarded temporary (src/pairing.rs:21)."""
        return self.conjugate()

    def cyclotomic_exp(self, exponent: int):
        if exponent < 0:
            return self.cyclotomic_inverse().cyclotomic_exp(-exponent)
        result = Fp12.one()
        found = False
        for bit in bin(exponent)[2:] if exponent else "":
            if found:
                result = result.cyclotomic_square()
            if bit == "1":
                result = result * self if found else self
                found = True
        return result

    @classmethod
    def characteristic(cls):
        return OF.P


Gt = Fp12  # export alias, ark-blst src/lib.rs:12
