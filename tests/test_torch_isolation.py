"""The port stands alone: importing `ark_blst_tpu_torch` and every submodule
loads neither JAX nor any module of the JAX package, and an entry point
asked for CUDA without a card raises instead of running on the CPU."""

import os
import subprocess
import sys
import textwrap

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code):
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)], cwd=REPO,
                          capture_output=True, text=True, timeout=300)


def test_port_imports_no_jax_and_no_jax_package():
    proc = _run("""
        import importlib, pkgutil, sys
        sys.modules["jax"] = None  # any import of jax now fails
        import ark_blst_tpu_torch as pkg
        names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
        for name in names:
            importlib.import_module(name)
        bad = [m for m, mod in sys.modules.items() if mod is not None and (
            m == "ark_blst_tpu" or m.startswith("ark_blst_tpu.") or m.split(".")[0] == "jax")]
        print(len(names), bad)
        assert not bad, bad
        assert "ark_blst_tpu_torch.curves.msm_bucket" in names, names
        assert "ark_blst_tpu_torch.curves.instance" in names, names
        assert "ark_blst_tpu_torch.curves.pairing" in names, names
        for mod in ("ops.strict_field", "ops.dispatch", "ops.tower", "curves.group",
                    "curves.msm", "ops.fp12_sqr", "ops.fp12_mul_by_014",
                    "curves.pairing_steps", "fields", "groups", "oracle.serialize",
                    "config", "distributed", "ops.fp_inv"):
            assert "ark_blst_tpu_torch." + mod in names, names
    """)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("entry", ["msm_g1", "G1.msm", "pairing", "bls12.pairing_batch",
                                   "bls12.prepare_g2_batch", "bls12.multi_pairing",
                                   "msm_g2", "G2.msm", "curves.msm.msm",
                                   "curves.msm.msm_naive", "pairing[strict]",
                                   "bls12.pairing_batch[unfused]",
                                   "bls12.prepare_g2_batch[unfused]",
                                   "bls12.multi_miller_loop", "G1Projective.msm",
                                   "G2Projective.msm", "Bls12.pairing_batch",
                                   "Bls12.prepare_g2_batch", "Bls12.multi_miller_loop",
                                   "Bls12.pairing", "Bls12.multi_pairing",
                                   "Bls12.pairing_batch[unfused]",
                                   "Bls12.prepare_g2_batch[unfused]", "G1Projective.msm[empty]",
                                   "distributed.initialize", "curves.msm.msm_auto",
                                   "curves.msm.msm_auto[g2]"])
def test_cuda_without_a_card_raises(entry):
    if torch.cuda.is_available():
        pytest.skip("a card is present; this checks the behaviour without one")
    import ark_blst_tpu_torch as T
    from ark_blst_tpu_torch import bls12 as B
    from ark_blst_tpu_torch import distributed as D
    from ark_blst_tpu_torch.curves import msm as M
    from ark_blst_tpu_torch.curves.group import G2 as CG2
    from ark_blst_tpu_torch.ops import convert as CV
    from ark_blst_tpu_torch.oracle.field import G1_GEN, G2_GEN

    p = (CV.fp_to_dev([G1_GEN[0]]), CV.fp_to_dev([G1_GEN[1]]))
    q = (CV.fp2_to_dev([G2_GEN[0]]), CV.fp2_to_dev([G2_GEN[1]]))
    g1, g2 = T.G1Affine.generator(), T.G2Projective.generator()
    calls = {  # each with the default device, cuda
        "msm_g1": lambda: T.msm_g1(CV.g1_to_dev([G1_GEN]), CV.fr_to_dev([3])),
        "G1.msm": lambda: T.G1.msm([G1_GEN], [3]),
        "pairing": lambda: T.pairing(p, q),
        "bls12.pairing_batch": lambda: B.pairing_batch([G1_GEN], [G2_GEN]),
        "bls12.prepare_g2_batch": lambda: B.prepare_g2_batch([G2_GEN]),
        "bls12.multi_pairing": lambda: B.multi_pairing([G1_GEN], [G2_GEN]),
        "msm_g2": lambda: T.msm_g2(CV.g2_to_dev([G2_GEN]), CV.fr_to_dev([3])),
        "G2.msm": lambda: T.G2.msm([G2_GEN], [3]),
        "curves.msm.msm": lambda: M.msm(CV.g1_to_dev([G1_GEN]), CV.fr_to_dev([3])),
        "curves.msm.msm_naive": lambda: M.msm_naive(CV.g1_to_dev([G1_GEN]), CV.fr_to_dev([3])),
        "pairing[strict]": lambda: T.pairing(p, q, engine="strict"),
        "bls12.pairing_batch[unfused]": lambda: B.pairing_batch([G1_GEN], [G2_GEN], fuse=False),
        "bls12.prepare_g2_batch[unfused]": lambda: B.prepare_g2_batch([G2_GEN], fuse=False),
        "bls12.multi_miller_loop": lambda: B.multi_miller_loop([G1_GEN], [G2_GEN]),
        "G1Projective.msm": lambda: T.G1Projective.msm([g1], [T.Scalar(3)]),
        "G2Projective.msm": lambda: T.G2Projective.msm([g2], [T.Scalar(3)]),
        "G1Projective.msm[empty]": lambda: T.G1Projective.msm([], []),
        "Bls12.pairing_batch": lambda: T.Bls12.pairing_batch([g1], [g2]),
        "Bls12.prepare_g2_batch": lambda: T.Bls12.prepare_g2_batch([g2]),
        "Bls12.multi_miller_loop": lambda: T.Bls12.multi_miller_loop([g1], [g2]),
        "Bls12.pairing": lambda: T.Bls12.pairing(g1, g2),
        "Bls12.multi_pairing": lambda: T.Bls12.multi_pairing([g1], [g2]),
        "Bls12.pairing_batch[unfused]": lambda: T.Bls12.pairing_batch([g1], [g2], fuse=False),
        "Bls12.prepare_g2_batch[unfused]": lambda: T.Bls12.prepare_g2_batch([g2], fuse=False),
        "distributed.initialize": lambda: D.initialize("localhost:1", 1, 0),
        "curves.msm.msm_auto": lambda: M.msm_auto(CV.g1_to_dev([G1_GEN]), CV.fr_to_dev([3])),
        "curves.msm.msm_auto[g2]": lambda: M.msm_auto(CV.g2_to_dev([G2_GEN]), CV.fr_to_dev([3]),
                                                      CG2),
    }
    with pytest.raises(RuntimeError, match="CUDA"):
        calls[entry]()


def test_msm_distributed_without_a_card_raises():
    """A mesh on the card comes only from `initialize(device="cuda")`, which
    raises without one (above); with no process group `msm_distributed`
    raises instead of forming one on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present; this checks the behaviour without one")
    from ark_blst_tpu_torch import distributed as D
    from ark_blst_tpu_torch.ops import convert as CV
    from ark_blst_tpu_torch.oracle.field import G1_GEN

    with pytest.raises(RuntimeError, match="initialize"):
        D.msm_distributed(CV.g1_to_dev([G1_GEN]), CV.fr_to_dev([3]))
    assert not torch.distributed.is_initialized()
