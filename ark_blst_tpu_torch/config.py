"""Typed configuration and memory-budgeted MSM planning.

Counterpart of `ark_blst_tpu/config.py`, name for name (`MsmPlan`,
`plan_msm`, `MeshConfig`). The reference sizes its GPU launches from device
memory (`calc_chunk_size`, its `src/gpu.rs:64-85`) and hardcodes
window heuristics (`MAX_WINDOW_SIZE=10`, work-unit scaling,
src/gpu.rs:16-42, 218-223). This module chooses a typed plan (window bits
`c`, point streams `lanes`) for the strict engine's scan MSM
(`curves/msm.py:msm`) from an explicit memory budget and a Pippenger cost
model instead.

Cost model (batched complete group adds, see curves/msm.py):
  accumulate: n * W              (W = ceil(256/c) windows)
  lane fold:  (lanes-1) * W * B  (B = 2^c buckets)
  bucket red: 2 * B * W
  horner:     c*W doublings + W adds (sequential tail, negligible)
Bucket memory: lanes * W * B * coords * limbs * 4 bytes. The scan MSM keeps
its buckets as int32 16-bit limbs, as the JAX package does, so the memory
model is the same.
"""

from __future__ import annotations

from dataclasses import dataclass

LIMB_BYTES = 4  # int32 storage per 16-bit limb
SCALAR_BITS = 256


@dataclass(frozen=True)
class MsmPlan:
    """A fully determined single-device MSM execution plan."""

    n: int
    c: int  # window bits
    lanes: int  # parallel point streams (power of two)
    coords: int  # projective coordinates (3)
    limbs: int  # base-field limbs per coordinate value (G1: 24, G2: 48)

    @property
    def windows(self) -> int:
        return (SCALAR_BITS + self.c - 1) // self.c

    @property
    def buckets(self) -> int:
        return 1 << self.c

    @property
    def bucket_bytes(self) -> int:
        return (
            self.lanes * self.windows * self.buckets * self.coords
            * self.limbs * LIMB_BYTES
        )

    @property
    def est_adds(self) -> int:
        W, B = self.windows, self.buckets
        return self.n * W + (self.lanes - 1) * W * B + 2 * B * W

    @property
    def steps(self) -> int:
        return -(-self.n // self.lanes)


def plan_msm(
    n: int,
    hbm_budget_bytes: int = 6 << 30,
    coords: int = 3,
    limbs: int = 24,
    max_lanes: int = 1024,
    min_lanes: int = 8,
    max_c: int = 16,
) -> MsmPlan:
    """Pick (c, lanes) minimizing estimated group adds subject to the bucket
    array fitting the memory budget and the scan staying reasonably shallow.

    Where the JAX package asserts, this raises `ValueError`: for n < 1, and
    when no plan fits the budget (the assert would vanish under `-O`).
    """
    if n < 1:
        raise ValueError(f"plan_msm needs n >= 1, got {n}")
    best = None
    lanes_cap = max(min_lanes, min(max_lanes, n))
    for c in range(4, max_c + 1):
        lanes = 1 << (lanes_cap.bit_length() - 1)  # largest pow2 <= cap
        while lanes >= min_lanes:
            p = MsmPlan(n=n, c=c, lanes=lanes, coords=coords, limbs=limbs)
            if p.bucket_bytes <= hbm_budget_bytes:
                if best is None or p.est_adds < best.est_adds:
                    best = p
                break  # smaller lanes only raises steps at same c
            lanes //= 2
    if best is None:
        raise ValueError(f"no plan fits the memory budget of {hbm_budget_bytes} bytes")
    return best


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh description for sharded entry points."""

    shape: tuple = (1,)
    axis_names: tuple = ("data",)
