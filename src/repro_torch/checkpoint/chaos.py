"""Fault-injection harness: SIGKILL a training run, resume, assert identity.

The port of the JAX package's ``checkpoint/chaos.py``.  One trial is three
acts:

1. **Reference** — a child process trains the spec'd plan uninterrupted
   and dumps its result (final params bytes + every ``History`` series).
2. **Kill** — a fresh child trains the same spec with checkpointing; it is
   SIGKILLed at a chosen (or random) round, either by itself right after
   that round's checkpoint is durable (``kill_mode="self"``, the
   ``REPRO_CHAOS_KILL_ROUND`` hook of
   :class:`~repro_torch.checkpoint.manager.CheckpointManager`) or by the
   parent the instant the round's manifest appears (``kill_mode="signal"``:
   the kill lands anywhere in the next round's work, so torn writes and the
   latest-valid fallback are exercised too).  The child is then relaunched
   with the SAME command; it resumes from the latest valid checkpoint
   (:func:`repro_torch.launch.train.run_or_resume`) and completes.
3. **Verdict** — :func:`assert_identical` compares the two dumps bit for
   bit: params bytes, val/train curves, byte and step accounting, retrace
   counts.

Children run ``python -m repro_torch.checkpoint.chaos`` on the device the
spec names (``"cuda"`` unless the caller passes another).  On a GPU the
gathers' backward (``index_add_``) adds float atomics in a varying order,
so two uninterrupted runs need not agree bit for bit; a child on a CUDA
device therefore runs under ``torch.use_deterministic_algorithms(True)``
(``index_add_`` then takes its sorted path, and cuBLAS a fixed workspace),
which makes the runs, and the killed and resumed one, repeat bit for bit
as on the CPU.  A ``shard_map`` child is the lead rank of its machine group
(:func:`repro_torch.launch.mesh.launch_machines`); the other ranks die with
it, and the relaunched group resumes each machine from the lead rank's
checkpoint.  ``placement="device"`` trains on device-drawn samples, whose
stream is stateless per round.

CLI::

    python -m repro_torch.checkpoint.chaos --kill-round 2 --device cpu
    python -m repro_torch.checkpoint.chaos --kill-round 0   # random round
    python -m repro_torch.checkpoint.chaos --backend shard_map --machines 2
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import random
import signal
import subprocess
import sys
import tempfile
import time
from typing import Dict, Optional

import numpy as np

#: Exit-status values meaning "the child died by SIGKILL" (POSIX negative
#: returncode from subprocess; 137 = 128+9 when a shell is in between).
_KILLED = (-signal.SIGKILL, 128 + signal.SIGKILL)

#: the ``src`` directory holding this package, put on the children's path
_SRC = str(pathlib.Path(__file__).resolve().parents[2])


def default_spec(**overrides) -> Dict:
    """The JSON-able trial spec: small, and it exercises the works — ρ>1 K
    growth, K-bucketing, the int8_ef residual and its uniform stream, the
    server correction."""
    spec = {
        "num_nodes": 120, "seed": 0, "rounds": 4, "local_k": 2, "rho": 1.5,
        "num_machines": 2, "compression": "int8_ef", "placement": "host",
        "backend": "vmap", "keep": 3, "async_": True, "every": 1,
        "device": "cuda", "ckpt_dir": None, "out": None,
    }
    spec.update(overrides)
    return spec


# --------------------------------------------------------------------------
# child side
# --------------------------------------------------------------------------
def _build(spec: Dict):
    from repro_torch.core.plan import (
        CheckpointSpec, CommSpec, CompileSpec, LocalSpec, SamplerSpec,
        ScheduleSpec, ServerSpec, TrainPlan, averaging, correction,
        local_steps,
    )
    from repro_torch.graph.datasets import sbm_graph
    from repro_torch.models.gnn.model import build_model

    data = sbm_graph(num_nodes=spec["num_nodes"], num_classes=3,
                     feature_dim=8, seed=spec["seed"])
    model = build_model("GG", data.feature_dim, data.num_classes,
                        hidden_dim=16)
    ck = None
    if spec["ckpt_dir"]:
        ck = CheckpointSpec(dir=spec["ckpt_dir"], keep=spec["keep"],
                            async_=spec["async_"], every=spec["every"])
    plan = TrainPlan(
        phases=(local_steps(), averaging(), correction()),
        local=LocalSpec(local_k=spec["local_k"], batch_size=8, lr=1e-2),
        server=ServerSpec(correction_steps=1, server_batch_size=16),
        comm=CommSpec(num_machines=spec["num_machines"],
                      compression=spec["compression"]),
        sampler=SamplerSpec(placement=spec["placement"]),
        schedule=ScheduleSpec(rounds=spec["rounds"], rho=spec["rho"]),
        compile=CompileSpec(k_bucketing=True),
        name="chaos", seed=spec["seed"], checkpoint=ck)
    return data, model, plan


def _dump_result(path: str, hist) -> None:
    from repro_torch.checkpoint.store import to_host
    from repro_torch.utils.pytree import flatten_with_paths
    payload = {}
    for key, leaf in flatten_with_paths(hist.meta["final_params"]):
        # raw bytes: dtype-agnostic bit identity
        payload["p/" + key] = np.frombuffer(
            np.ascontiguousarray(to_host(leaf)).tobytes(), np.uint8)
    lloss = [np.nan if v is None else v for v in hist.meta["local_loss"]]
    payload.update(
        rounds=np.asarray(hist.rounds, np.int64),
        steps_cum=np.asarray(hist.steps_cum, np.int64),
        val_score=np.asarray(hist.val_score, np.float64),
        train_loss=np.asarray(hist.train_loss, np.float64),
        bytes_cum=np.asarray(hist.bytes_cum, np.float64),
        local_loss=np.asarray(lloss, np.float64),
        corr_loss=np.asarray(hist.meta["corr_loss"], np.float64),
        num_retraces=np.asarray(hist.meta["num_retraces"], np.int64),
        num_corr_retraces=np.asarray(hist.meta["num_corr_retraces"],
                                     np.int64),
        sampler_retraces=np.asarray(hist.meta["sampler_retraces"], np.int64),
        masked_steps=np.asarray(hist.meta["masked_steps"], np.int64))
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
    os.replace(tmp, path)


def _train(mesh, spec: Dict):
    """Train the spec's plan (resuming from its checkpoints, if any) as one
    process (``mesh=None``), or as machine ``mesh.rank`` of a shard_map
    group."""
    data, model, plan = _build(spec)
    kw = dict(device=spec["device"], backend=spec["backend"], mesh=mesh)
    if plan.checkpoint is not None:
        from repro_torch.launch.train import run_or_resume
        return run_or_resume(data, model, plan, **kw)
    from repro_torch.core.plan import build_trainer
    return build_trainer(data, model, plan, **kw).run()


def child_main(spec_path: str) -> None:
    """One training attempt: a fresh run, or a resume if checkpoints exist."""
    with open(spec_path) as f:
        spec = json.load(f)
    import torch
    cuda = torch.device(spec["device"]).type == "cuda"
    if spec["backend"] == "shard_map":
        from repro_torch.launch.mesh import launch_machines
        hist = launch_machines(_train, spec["num_machines"], spec,
                               device=spec["device"], deterministic=cuda)
    else:
        if cuda:
            torch.use_deterministic_algorithms(True)
        hist = _train(None, spec)
    _dump_result(spec["out"], hist)


# --------------------------------------------------------------------------
# parent side
# --------------------------------------------------------------------------
def _child_env(kill_round: Optional[int]) -> Dict[str, str]:
    env = dict(os.environ)
    path = env.get("PYTHONPATH")
    env["PYTHONPATH"] = _SRC + (os.pathsep + path if path else "")
    # cuBLAS repeats bit for bit only with a fixed workspace; read when a
    # CUDA child first calls cuBLAS, harmless on the CPU
    env.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    if kill_round is not None:
        env["REPRO_CHAOS_KILL_ROUND"] = str(kill_round)
    else:
        env.pop("REPRO_CHAOS_KILL_ROUND", None)
    return env


def _launch(spec_path: str, env: Dict[str, str]) -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.checkpoint.chaos", "--spec",
         spec_path], env=env)


def _await_manifest_and_kill(proc: subprocess.Popen, ckpt_dir: str,
                             kill_round: int, timeout: float) -> None:
    """kill_mode="signal": SIGKILL the child the moment round
    ``kill_round``'s manifest lands."""
    target = os.path.join(ckpt_dir, f"ckpt_{kill_round}.json")
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            return                       # finished before we could kill it
        if os.path.exists(target):
            proc.kill()                  # SIGKILL
            proc.wait()
            return
        time.sleep(0.02)
    proc.kill()
    proc.wait()
    raise RuntimeError(f"round-{kill_round} manifest never appeared under "
                       f"{ckpt_dir} within {timeout}s")


def _spec_file(spec: Dict) -> str:
    with tempfile.NamedTemporaryFile("w", suffix=".json",
                                     delete=False) as f:
        json.dump(spec, f)
        return f.name


def run_trial(spec: Dict, kill_round: int, kill_mode: str = "self",
              timeout: float = 900.0, max_relaunches: int = 4) -> Dict:
    """Train under a SIGKILL at ``kill_round``; relaunch until completion.

    Returns the loaded result dump of the finally completed run.  The first
    launch dies; each relaunch uses the SAME spec, and ``run_or_resume``
    picks up the latest valid checkpoint.
    """
    if kill_mode not in ("self", "signal"):
        raise ValueError(f"unknown kill_mode {kill_mode!r}")
    spec_path = _spec_file(spec)
    try:
        killed = False
        for attempt in range(max_relaunches):
            self_kill = kill_mode == "self" and not killed
            proc = _launch(spec_path,
                           _child_env(kill_round if self_kill else None))
            if kill_mode == "signal" and not killed:
                _await_manifest_and_kill(proc, spec["ckpt_dir"], kill_round,
                                         timeout)
            rc = proc.wait(timeout=timeout)
            if rc == 0:
                return load_result(spec["out"])
            if rc not in _KILLED:
                raise RuntimeError(
                    f"chaos child failed with rc={rc} (not a SIGKILL) on "
                    f"attempt {attempt}")
            killed = True
        raise RuntimeError(
            f"child never completed within {max_relaunches} launches")
    finally:
        os.unlink(spec_path)


def run_uninterrupted(spec: Dict, timeout: float = 900.0) -> Dict:
    """The reference: same spec, no checkpointing, no kill, one process."""
    ref = dict(spec, ckpt_dir=None)
    spec_path = _spec_file(ref)
    try:
        rc = _launch(spec_path, _child_env(None)).wait(timeout=timeout)
        if rc != 0:
            raise RuntimeError(f"reference child failed with rc={rc}")
        return load_result(ref["out"])
    finally:
        os.unlink(spec_path)


def load_result(path: str) -> Dict[str, np.ndarray]:
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k].copy() for k in z.files}


def assert_identical(ref: Dict[str, np.ndarray],
                     got: Dict[str, np.ndarray]) -> None:
    """Bit identity across every dumped series and every param leaf."""
    if sorted(ref) != sorted(got):
        raise AssertionError(f"result keys differ: {sorted(ref)} vs "
                             f"{sorted(got)}")
    diffs = []
    for k in sorted(ref):
        a, b = ref[k], got[k]
        eq = (np.array_equal(a, b, equal_nan=True)
              if a.dtype.kind == "f" else np.array_equal(a, b))
        if not eq:
            diffs.append(k)
    if diffs:
        raise AssertionError(f"killed+resumed run diverged from the "
                             f"uninterrupted one at: {diffs}")


def run_chaos(backend: str = "vmap", kill_round: int = 2,
              kill_mode: str = "self", placement: str = "host",
              machines: int = 2, rounds: int = 4,
              compression: str = "int8_ef", seed: int = 0,
              device: str = "cuda") -> None:
    """One full chaos trial; raises on any divergence."""
    if kill_round == 0:
        kill_round = random.Random(seed ^ 0xC4A05).randint(1, rounds - 1)
    with tempfile.TemporaryDirectory() as td:
        spec = default_spec(
            backend=backend, placement=placement, num_machines=machines,
            rounds=rounds, compression=compression, seed=seed,
            device=device, ckpt_dir=os.path.join(td, "ckpt"),
            out=os.path.join(td, "killed.npz"))
        got = run_trial(spec, kill_round, kill_mode=kill_mode)
        ref = run_uninterrupted(dict(spec, out=os.path.join(td, "ref.npz")))
        assert_identical(ref, got)
    print(f"chaos ok: backend={backend} placement={placement} "
          f"P={machines} kill_round={kill_round} mode={kill_mode} "
          f"device={device} — bit-identical after SIGKILL + resume")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--spec", help="(internal) child mode: run this spec")
    ap.add_argument("--backend", default="vmap",
                    choices=("vmap", "shard_map"))
    ap.add_argument("--placement", default="host",
                    choices=("host", "device"))
    ap.add_argument("--machines", type=int, default=2)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--kill-round", type=int, default=2,
                    help="round to kill at (0 = random)")
    ap.add_argument("--kill-mode", default="self",
                    choices=("self", "signal"))
    ap.add_argument("--compression", default="int8_ef")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.spec:
        child_main(args.spec)
        return 0
    run_chaos(backend=args.backend, kill_round=args.kill_round,
              kill_mode=args.kill_mode, placement=args.placement,
              machines=args.machines, rounds=args.rounds,
              compression=args.compression, seed=args.seed,
              device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
