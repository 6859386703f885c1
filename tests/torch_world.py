"""A world of ranks of the port's sharded entries, each rank a child process
over gloo on the CPU, for the tests.

    results = run_world("msm_sharded2", args, world=2, tmp=tmp_path)

The parent writes the global inputs (canonical ints, made with any oracle)
to a JSON file and starts one child per rank,

    python tests/torch_world.py JOB RANK WORLD PORT ARGS.json OUT.json

Each child blocks `jax` and the JAX package from import, joins the group
through `distributed.initialize` (tcp on localhost, gloo), builds its mesh
with `distributed.global_mesh`, runs JOB on the same global inputs as every
other rank and writes its result as canonical ints. The parent waits for
all of them under one hard timeout and kills every child when it fires or
when one child fails, so a hung rendezvous fails the test. Returns the
ranks' results in rank order.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_world(job: str, args: dict, world: int, tmp, timeout: float = 120.0) -> list:
    """Run `job` on `world` ranks; returns each rank's result (rank order)."""
    port = _free_port()
    args_path = os.path.join(str(tmp), f"{job}_args.json")
    with open(args_path, "w") as f:
        json.dump(args, f)
    procs, outs, logs = [], [], []
    try:
        for rank in range(world):
            out = os.path.join(str(tmp), f"{job}_rank{rank}.json")
            log = open(os.path.join(str(tmp), f"{job}_rank{rank}.log"), "w+")
            outs.append(out)
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), job, str(rank), str(world),
                 str(port), args_path, out],
                cwd=REPO, stdout=log, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        while any(p.poll() is None for p in procs):
            failed = [r for r, p in enumerate(procs) if p.returncode not in (None, 0)]
            if failed or time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        text = []
        for rank, log in enumerate(logs):
            log.seek(0)
            text.append(f"--- rank {rank} (exit {procs[rank].returncode}) ---\n{log.read()}")
            log.close()
    report = "\n".join(text)
    if any(p.returncode != 0 for p in procs):
        raise AssertionError(f"world {job!r} failed or passed its {timeout} s timeout\n{report}")
    results = []
    for out in outs:
        with open(out) as f:
            results.append(json.load(f))
    return results


# --- the child ------------------------------------------------------------------

def _tuples(x):
    """JSON lists back into the oracle's tuples."""
    return tuple(_tuples(v) for v in x) if isinstance(x, list) else x


def _strict_points(curve: str, pts):
    from ark_blst_tpu_torch.ops import convert as CV

    return (CV.g2_to_dev if curve == "g2" else CV.g1_to_dev)(list(pts))


def _affine(curve: str, pt) -> list:
    from ark_blst_tpu_torch.ops import convert as CV

    return (CV.g2_from_dev if curve == "g2" else CV.g1_from_dev)(pt)


def _msm_inputs(args):
    from ark_blst_tpu_torch.ops import convert as CV

    curve = args["curve"]
    return curve, _strict_points(curve, _tuples(args["points"])), CV.fr_to_dev(args["scalars"])


def job_msm_distributed(mesh, args):
    """`msm_distributed` on the default backend (scan on the CPU)."""
    from ark_blst_tpu_torch import distributed as D
    from ark_blst_tpu_torch.curves.group import G1, G2

    curve, pts, scs = _msm_inputs(args)
    out = D.msm_distributed(pts, scs, curve=G2 if curve == "g2" else G1, c=args["c"],
                            lanes=args["lanes"], mesh=mesh)
    return {"point": _affine(curve, out)}


def job_msm_sharded2(mesh, args):
    from ark_blst_tpu_torch.curves import msm_bucket as MB

    curve, pts, scs = _msm_inputs(args)
    kc = MB.KC2_G2 if curve == "g2" else MB.KC2_G1
    out = MB.msm_sharded2(pts, scs, mesh, kc, c=args["c"], max_windows=args["max_windows"])
    return {"point": _affine(curve, out)}


def job_msm_sharded(mesh, args):
    from ark_blst_tpu_torch.curves import msm as M
    from ark_blst_tpu_torch.curves.group import G1, G2

    curve, pts, scs = _msm_inputs(args)
    out = {}
    for finish in ("device", "host"):
        got = M.msm_sharded(pts, scs, mesh, G2 if curve == "g2" else G1, c=args["c"],
                            lanes=args["lanes"], finish=finish)
        out[finish] = _affine(curve, got)
    return out


def job_multi_pairing_sharded(mesh, args):
    import torch

    from ark_blst_tpu_torch import bls12 as B
    from ark_blst_tpu_torch.curves import pairing as PR
    from ark_blst_tpu_torch.ops import convert as CV

    cpu = torch.device("cpu")
    p, p_inf = B._g1_batch(_tuples(args["ps"]), cpu)
    q, q_inf = B._g2_batch(_tuples(args["qs"]), cpu)
    out = PR.multi_pairing_sharded(p, q, mesh, p_inf=p_inf, q_inf=q_inf,
                                   final=args["final"], events=args["events"])
    return {"fp12": CV.fp12_from_dev(out)}


def _child(argv) -> None:
    job, rank, world, port, args_path, out_path = argv
    sys.modules["jax"] = None  # the port runs without JAX: any import of it fails
    sys.modules["ark_blst_tpu"] = None
    sys.path.insert(0, REPO)
    import torch

    from ark_blst_tpu_torch import distributed as D

    torch.set_num_threads(1)
    with open(args_path) as f:
        args = json.load(f)
    D.initialize(f"localhost:{port}", int(world), int(rank), device="cpu")
    D.initialize()  # a second call returns at once
    mesh = D.global_mesh()
    result = globals()["job_" + job](mesh, args)
    result["mesh"] = {"size": mesh.shape["data"], "rank": mesh.rank, "backend": str(mesh.backend),
                      "sharing": mesh.sharing, "gathers": mesh.gathers}
    with open(out_path, "w") as f:
        json.dump(result, f)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    _child(sys.argv[1:])
