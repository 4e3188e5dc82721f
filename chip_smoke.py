#!/usr/bin/env python
"""Smoke test of the training main path on NVIDIA GPUs.

    python chip_smoke.py             # one card: device, gpu tests, step, cli
    python chip_smoke.py --cards 4   # only the four-card comparison

The parent process never imports JAX. It runs each phase as a child process,
one after another, so only one JAX process holds the card at any time, and
streams the children's output. A child that fails or overruns its time ends
the run with a non-zero exit and no result line. The phases:

  device  JAX must run on a GPU (no CPU fallback); prints the card, the
          versions, XLA_FLAGS and the compile cache in use.
  tests   ``pytest -m gpu tests/`` on the card; none may skip.
  step    both phase programs of confs/wmask_rnb.conf at full width
          (8x256 SDF with a 257-wide head and a skip at layer 4, 2x256 albedo
          net, 64+64 samples over 4 up-sample rounds, batch 512, 3 lights):
          compile time, memory_analysis(), the dot algorithm in the HLO,
          ms/step, and the SDF core's vjp and fwdmode forms timed alone.
  cli     the user's entry points: tools/make_synthetic_case.py (a sphere of
          radius 0.35), exp_runner.py train_rnb across the warm-up -> main
          boundary with a checkpoint and a validation render, a second
          train_rnb --is_continue from that checkpoint, validate_mesh at 512^3;
          then the mesh must be that sphere and made by native marching cubes.
  cards   (--cards N only) the ray-sharded step on an N-card mesh against
          the single-card step on the same global batch, plus the
          view-sharded step.

The line before the last is nvidia-smi's name and power limit. The last line
of stdout is {"ok": true, "device": {"platform", "kind", "count"}}.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CASE = "chip_smoke_sphere"
RADIUS = 0.35
MESH_RES = 512
EXP_DIR = os.path.join(ROOT, "exp", CASE, "wmask_rnb")
# the shortened schedule: the warm-up program to 600, checkpoint and
# validation render at 1000 where the first run ends, resume to 2000
FIRST_END, SECOND_END = 1000, 2000
TRAIN_SET = ["train.warm_up_iter=600", "train.warm_up_end=50",
             "train.save_freq=1000", "train.val_freq=1000",
             "train.val_mesh_freq=1000000", "train.report_freq=200"]


def smi(query: str = "name,power.limit") -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


# ---------------------------------------------------------------------------
# parent: runs children, never imports JAX
# ---------------------------------------------------------------------------

def run_child(label: str, argv: list[str], timeout: float,
              env: dict | None = None) -> str:
    """Run one child in its own process group, stream its output with a
    prefix, return it; exit non-zero if it fails or overruns."""
    t0 = time.perf_counter()
    print(f"[{label}] $ {' '.join(argv)}", flush=True)
    proc = subprocess.Popen(argv, cwd=ROOT, env={**os.environ, **(env or {})},
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, start_new_session=True)
    lines = []
    deadline = time.monotonic() + timeout
    try:
        for line in proc.stdout:
            lines.append(line)
            print(f"[{label}] {line}", end="", flush=True)
            if time.monotonic() > deadline:
                raise subprocess.TimeoutExpired(argv, timeout)
        proc.wait(timeout=max(deadline - time.monotonic(), 1))
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()
        sys.exit(f"[{label}] FAILED: over its {timeout:.0f} s limit")
    if proc.returncode != 0:
        sys.exit(f"[{label}] FAILED: exit code {proc.returncode}")
    print(f"[{label}] done in {time.perf_counter() - t0:.1f} s", flush=True)
    return "".join(lines)


def child(phase: str, *args: str) -> list[str]:
    return [sys.executable, os.path.abspath(__file__), "--phase", phase,
            *args]


def losses(out: str) -> list[float]:
    return [float(x) for x in re.findall(r"iter:\s*\d+ loss=([0-9.eE+-]+)",
                                         out)]


def run_cli() -> None:
    data_dir = os.path.join("data", CASE)
    shutil.rmtree(os.path.join(ROOT, data_dir), ignore_errors=True)
    shutil.rmtree(EXP_DIR, ignore_errors=True)
    run_child("cli:case", [sys.executable, "tools/make_synthetic_case.py",
                           "--out", data_dir, "--n_views", "6", "--size",
                           "256", "--radius", str(RADIUS)], 300)
    runner = [sys.executable, "exp_runner.py", "--conf",
              "confs/wmask_rnb.conf", "--case", CASE]

    def sets(end_iter: int) -> list[str]:
        out = []
        for s in TRAIN_SET + [f"train.end_iter={end_iter}"]:
            out += ["--set", s]
        return out

    first = run_child("cli:train", runner + ["--mode", "train_rnb",
                                             "--mesh_resolution", "64"]
                      + sets(FIRST_END), 420)
    ckpt = os.path.join(EXP_DIR, "checkpoints", f"ckpt_{FIRST_END:06d}.npz")
    if not os.path.exists(ckpt):
        sys.exit(f"[cli] FAILED: no checkpoint at {ckpt}")
    if not os.listdir(os.path.join(EXP_DIR, "validations_fine")):
        sys.exit("[cli] FAILED: no validation render")
    second = run_child("cli:resume", runner + ["--mode", "train_rnb",
                                               "--is_continue",
                                               "--mesh_resolution", "64"]
                       + sets(SECOND_END), 420)
    if f"Find checkpoint: {os.path.basename(ckpt)}" not in second:
        sys.exit(f"[cli] FAILED: the second run did not resume from {ckpt}")
    curve = losses(first) + losses(second)
    print(f"[cli] loss every 200 steps: {curve}", flush=True)
    if not (len(curve) == 10 and curve[-1] < curve[0]):
        sys.exit("[cli] FAILED: the loss did not fall")
    out = run_child("cli:mesh", runner + ["--mode", "validate_mesh",
                                          "--is_continue",
                                          "--mesh_resolution", str(MESH_RES)]
                    + sets(SECOND_END), 420)
    if "marching cubes (native)" not in out:
        sys.exit("[cli] FAILED: the mesh was not made by native marching "
                 "cubes")
    run_child("cli:check", child(
        "mesh", os.path.join(EXP_DIR, "meshes", f"{SECOND_END:08d}.ply")), 120)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cards", type=int, default=1,
                    help="with N > 1, run only the N-card comparison")
    ap.add_argument("--phase", help=argparse.SUPPRESS)
    ap.add_argument("args", nargs="*", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.phase:
        PHASES[a.phase](*a.args)
        return

    t0 = time.perf_counter()
    dev_out = run_child("device", child("device", str(a.cards)), 180)
    device = json.loads(re.search(r"^DEVICE (\{.*\})$", dev_out,
                                  re.M).group(1))
    if a.cards > 1:
        run_child("cards", child("cards", str(a.cards)), 900)
    else:
        tests = run_child("tests", [sys.executable, "-m", "pytest", "-m",
                                    "gpu", "tests/", "-q", "-s", "-rs",
                                    "-p", "no:cacheprovider"], 420,
                          env={"JAX_PLATFORMS": "cuda"})
        if re.search(r"\d+ skipped", tests):
            sys.exit("[tests] FAILED: gpu tests skipped on the card")
        run_child("step", child("step"), 420)
        run_cli()
    print(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    print(smi())
    print(json.dumps({"ok": True, "device": device}))


# ---------------------------------------------------------------------------
# children (each imports JAX and holds the card alone)
# ---------------------------------------------------------------------------

def phase_device(cards: str = "1") -> None:
    import jax
    import jaxlib

    import rnb_tpu
    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit(f"no GPU: JAX runs on {devs[0].platform!r}")
    if len(devs) < int(cards):
        sys.exit(f"need {cards} cards, JAX sees {len(devs)}")
    print(f"device_kind {devs[0].device_kind!r}, {len(devs)} device(s)")
    print(f"nvidia-smi: {smi()}")
    print(f"jax {jax.__version__}, jaxlib {jaxlib.__version__}, XLA_FLAGS="
          f"{os.environ.get('XLA_FLAGS', '')!r}, compile cache "
          f"{jax.config.jax_compilation_cache_dir} "
          f"(rnb_tpu default {rnb_tpu.compile_cache_dir()})")
    print("DEVICE " + json.dumps({"platform": devs[0].platform,
                                  "kind": devs[0].device_kind,
                                  "count": len(devs)}))


def _production():
    """statics, train/render configs and initial params of the shipped
    conf at full width."""
    import jax

    from rnb_tpu import config as cfglib
    from rnb_tpu.models import fields, renderer as rnd
    from rnb_tpu.train import step as steplib
    conf = cfglib.load_conf(os.path.join(ROOT, "confs/wmask_rnb.conf"), CASE)
    statics = fields.statics_from_conf(conf["model"])
    tcfg = steplib.train_conf(conf)
    rcfg = steplib.apply_runtime_flags(rnd.renderer_conf(conf["model"]),
                                       tcfg)
    params = fields.init_model_bundle(jax.random.PRNGKey(0), statics)
    return statics, tcfg, rcfg, params


def dot_algorithms(hlo: str) -> dict:
    """Count the matmul calls of a compiled GPU program by library target and
    by the operand precision / algorithm they were given."""
    calls = re.findall(r'custom_call_target="(__cublas\$\w+)"', hlo)
    prec = re.findall(r'"operand_precision":\[([^\]]*)\]', hlo)
    algo = re.findall(r'"algorithm":"(\w+)"', hlo)
    count = lambda xs: {x: xs.count(x) for x in sorted(set(xs))}  # noqa
    return {"library_calls": count(calls), "operand_precision": count(prec),
            "algorithm": count(algo),
            "triton_fusions": hlo.count('"kind":"__triton')}


def _time(fn, n: int) -> float:
    """ms per call of fn(), to jax.block_until_ready, after one warm call."""
    import jax
    jax.block_until_ready(fn())
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn()
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / n * 1e3


def phase_step() -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from rnb_tpu.data import dataset as ds
    from rnb_tpu.models import fields
    from rnb_tpu.train import step as steplib
    statics, tcfg, rcfg, params = _production()
    card = smi()
    print(f"conf: {steplib.runtime_flags_dict(tcfg)}, {rcfg}, "
          f"batch {tcfg.batch_size}, {fields.param_count(params)} params")
    scene = ds.make_sphere_scene(n_views=6, H=256, W=256, radius=RADIUS)
    key = jax.random.PRNGKey(1)
    state = steplib.init_train_state(params, tcfg)
    for warmup in (True, False):
        name = "warm-up" if warmup else "main"
        fn = steplib.make_train_step(statics, rcfg, tcfg, warmup, False)
        t0 = time.perf_counter()
        compiled = fn.lower(state, scene.arrays, 0, key).compile()
        print(f"{name} program: compile {time.perf_counter() - t0:.1f} s, "
              f"{compiled.memory_analysis()}")
        print(f"{name} program dots: {dot_algorithms(compiled.as_text())}")
        first = None
        for i in range(3):
            state, m = compiled(state, scene.arrays, i % 6, key)
            first = first if first is not None else float(m["loss"])
        jax.block_until_ready(state)
        t0 = time.perf_counter()
        n = 20
        for i in range(n):
            state, m = compiled(state, scene.arrays, i % 6, key)
        jax.block_until_ready(state)
        ms = (time.perf_counter() - t0) / n * 1e3
        loss = float(m["loss"])
        print(f"{name} program: {ms:.3f} ms/step over {n} steps on {card} "
              f"(information, not a claim); loss {first:.5f} -> {loss:.5f}")
        if not np.isfinite(loss):
            sys.exit(f"{name} program: non-finite loss")

    # the differentiable SDF core alone, one step's points: forward +
    # backward of value, feature and an eikonal term, each form jitted once
    # (the initial params were donated to the step; use the trained ones)
    params = state.params
    rng = np.random.default_rng(0)
    pts = jnp.asarray(rng.uniform(-0.8, 0.8, (tcfg.batch_size * 128, 3)),
                      jnp.float32)
    for impl, core in (("vjp", fields.sdf_value_feat_grad),
                       ("fwdmode", fields.sdf_value_feat_grad_fwd)):
        def loss(p, x, core=core):
            sdf, feat, g = core(statics.sdf, p, x)
            return (sdf.sum() + 1e-3 * feat.sum()
                    + ((jnp.linalg.norm(g, axis=-1) - 1.0) ** 2).mean())
        f = jax.jit(jax.value_and_grad(loss))
        ms = _time(lambda: f(params["sdf"], pts), 20)
        print(f"sdf core {impl}: {ms:.3f} ms forward+backward at "
              f"{pts.shape[0]} points on {card}")


def phase_mesh(path: str) -> None:
    import numpy as np

    from rnb_tpu.utils.io import read_ply
    verts, faces, _ = read_ply(path)
    r = np.linalg.norm(verts, axis=-1)
    print(f"{path}: {len(verts)} vertices, {len(faces)} faces, radius mean "
          f"{r.mean():.5f} (target {RADIUS}), std {r.std():.5f}")
    if not (abs(r.mean() - RADIUS) < 0.02 and r.std() < 0.02):
        sys.exit("mesh is not the trained sphere")


def _update_diffs(new_a, new_b, old) -> tuple[float, float]:
    """Per-leaf differences of two parameter updates from the same state:
    the worst over leaves of the L2 difference over the L2 update, and of
    the largest element difference over the largest update element."""
    import jax
    import numpy as np
    l2, worst = [], []
    for a, b, p in zip(*(jax.tree_util.tree_leaves(t)
                         for t in (new_a, new_b, old))):
        da, db = np.asarray(a) - np.asarray(p), np.asarray(b) - np.asarray(p)
        if np.abs(db).max() > 0:
            l2.append(float(np.linalg.norm(da - db) / np.linalg.norm(db)))
            worst.append(float(np.abs(da - db).max() / np.abs(db).max()))
    return max(l2), max(worst)


def phase_cards(cards: str) -> None:
    """Ray-sharded step on an N-card mesh against the single-card step on
    the same global batch of 512, key and state; then the view-sharded step.

    Both sides run at 'highest' matmul precision with perturb=0: the check is
    of the sharding (sampling per card, psum of loss terms, pmean of
    gradients), so what is left to differ is the order of the sums. The
    shards draw their rays with their own keys; the single-card side is fed
    their union (parallel.train.shard_batches), and perturb=0 makes the
    render key unused. The state has taken 3 steps first, so Adam's moments
    are non-zero and the update is a smooth function of the gradient.

    Limits: the loss to 1e-5 relative (sums of 512 rays' terms in another
    order). Updates: Adam normalizes each element by its own history, so a
    gradient element that nearly cancels over the batch turns its summation
    noise into an update difference of the same order as the update itself
    (on 4 H100s the worst element measured 4.4e-3 of its leaf's largest
    update). Each leaf's update must agree to 1e-2 in L2 and to 5e-2 of its
    largest element in its worst element: above that noise, and an order of
    magnitude below what a sharding fault gives (a psum of the gradients in
    place of their pmean differs by 0.6). The floor of these measures is
    printed beside them: the single-card step on the same rays in reverse
    order, where nothing but the order of the sums changes."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    import numpy as np

    from rnb_tpu.data import dataset as ds
    from rnb_tpu.parallel import mesh as meshlib
    from rnb_tpu.parallel.data import shard_views
    from rnb_tpu.parallel.train import (make_sharded_train_step,
                                        make_view_sharded_train_step,
                                        shard_batches)
    from rnb_tpu.train import step as steplib
    n = int(cards)
    statics, tcfg, rcfg, params = _production()
    tcfg = dataclasses.replace(tcfg, matmul_precision="highest",
                               warm_up_end=0)
    rcfg = steplib.apply_runtime_flags(dataclasses.replace(rcfg, perturb=0.0),
                                       tcfg)
    scene = ds.make_sphere_scene(n_views=8, H=256, W=256, radius=RADIUS)
    mesh = meshlib.make_ray_mesh(n)
    key = jax.random.PRNGKey(3)

    single = steplib.make_train_step(statics, rcfg, tcfg, False, False,
                                     donate=False)
    state = steplib.init_train_state(params, tcfg)
    for i in range(3):
        state, _ = single(state, scene.arrays, i, key)

    sharded = make_sharded_train_step(statics, rcfg, tcfg, False, False, mesh,
                                      donate=False)
    s_sh, m_sh = sharded(state, scene.arrays, 5, key)
    batch = shard_batches(scene.arrays, 5, key, state.step, n,
                          tcfg.batch_size // n)
    on_batch = steplib.make_batch_train_step(statics, rcfg, tcfg, False,
                                             False)
    s_1, m_1 = on_batch(state, batch, key)
    # the same rays in reverse order ([L, B, 3] fields carry rays on axis 1)
    rev = ds.RayBatch(**{
        f: v if f == "lights_warmup" else jnp.flip(
            v, axis=1 if f in ("rgb_warmup", "rgb", "lights") else 0)
        for f, v in batch._asdict().items()})
    s_r, m_r = on_batch(state, rev, key)

    l_sh, l_1 = float(m_sh["loss"]), float(m_1["loss"])
    loss_rel = abs(l_sh - l_1) / abs(l_1)
    l2, worst = _update_diffs(s_sh.params, s_1.params, state.params)
    l2_floor, worst_floor = _update_diffs(s_r.params, s_1.params,
                                          state.params)
    print(f"{n}-card ray-sharded vs 1-card step, global batch "
          f"{tcfg.batch_size}: loss {l_sh:.7f} vs {l_1:.7f} (relative "
          f"{loss_rel:.2e}, limit 1e-5); parameter updates, worst leaf: L2 "
          f"{l2:.2e} (limit 1e-2), worst element {worst:.2e} (limit 5e-2); "
          f"floor from reversed ray order on 1 card: loss "
          f"{abs(float(m_r['loss']) - l_1) / abs(l_1):.2e}, L2 "
          f"{l2_floor:.2e}, worst element {worst_floor:.2e}")
    if not (loss_rel < 1e-5 and l2 < 1e-2 and worst < 5e-2):
        sys.exit("sharded and single-card steps disagree")

    vs = make_view_sharded_train_step(statics, rcfg, tcfg, False, False,
                                      mesh, donate=False)
    _, m_vs = vs(state, shard_views(scene.arrays, mesh), 0, key)
    print(f"{n}-card view-sharded step: loss {float(m_vs['loss']):.6f}")
    if not np.isfinite(float(m_vs["loss"])):
        sys.exit("view-sharded step: non-finite loss")


PHASES = {"device": phase_device, "step": phase_step, "mesh": phase_mesh,
          "cards": phase_cards}

if __name__ == "__main__":
    main()
