#!/usr/bin/env python
"""World-space parity on a NON-SQUARE, SELF-NORMALIZED capture
(VERDICT r4 weak #2 / next #3: every prior e2e fixture was square with
identity scale mats, so the world-space denormalization
(`/root/reference/exp_runner.py:573`) and H/W asymmetry in ray generation
were never exercised with non-trivial values).

Pipeline, exercising the offline L0 stage in the loop:

  1. synthesize a DiLiGenT-shaped capture: 612x512 (DiLiGenT-MV's image
     size), torus centered OFF-ORIGIN in world space, SDM-UniPS-style
     degradation (3deg normal noise, mask morphology, 8-bit maps, focal
     error), written UN-normalized (identity scale mats);
  2. run our own scene normalization (preprocess/preprocess_cameras.py) on
     it — cameras.npz then carries genuinely non-identity scale mats
     (`/root/reference/models/dataset.py:197-205`);
  3. train the wmask conf (compressed 30k/20k protocol of PARITY_r4) and
     extract the final 512^3 mesh in WORLD space;
  4. gate: Chamfer-L1 vs the analytic torus at its WORLD center, measured
     in WORLD units, threshold = 0.004 UNSCALED — the analytic torus is
     physically identical to the square-case one (only translated), so the
     world-unit gate equals the r4 gate; the scale_mat changes the
     training-internal representation, not the object's size.

Usage: python tools/run_parity_worldspace.py [--iters 30000]
       [--out PARITY_r5_worldspace.json]

One JAX process at a time: every stage is a child process that ends before
the next starts, so a card is never shared between two of them.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CENTER = (0.15, -0.1, 0.08)


def run(cmd, **kw):
    print("+", " ".join(cmd), flush=True)
    return subprocess.run(cmd, cwd=ROOT, **kw)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--case", default="torus_ns")
    ap.add_argument("--iters", type=int, default=30000)
    ap.add_argument("--warmup", type=int, default=20000)
    ap.add_argument("--width", type=int, default=612)
    ap.add_argument("--height", type=int, default=512)
    ap.add_argument("--n_views", type=int, default=8)
    ap.add_argument("--mesh_resolution", type=int, default=512)
    ap.add_argument("--out", default="PARITY_r5_worldspace.json")
    ap.add_argument("--skip_existing", action="store_true")
    args = ap.parse_args(argv)

    data_dir = os.path.join(ROOT, "data", args.case)
    if not os.path.isdir(data_dir):
        run([sys.executable, "tools/make_synthetic_case.py", "--out",
             f"data/{args.case}", "--shape", "torus", "--degrade",
             "--n_views", str(args.n_views),
             "--width", str(args.width), "--height", str(args.height),
             "--center", *[str(c) for c in CENTER], "--normalize"],
            check=True)

    cams = np.load(os.path.join(data_dir, "cameras.npz"))
    scale_mat = cams["scale_mat_0"]
    scale = float(scale_mat[0, 0])
    assert abs(scale - 1.0) > 0.05 or np.abs(scale_mat[:3, 3]).max() > 0.05, (
        "case is not actually normalized — scale mats look like identity")

    exp_dir = os.path.join(ROOT, "exp", args.case, "wmask_rnb")
    t0 = time.time()
    trained = False
    if not (args.skip_existing
            and os.path.isdir(os.path.join(exp_dir, "meshes"))):
        if os.path.isdir(exp_dir):
            shutil.rmtree(exp_dir)
        ovr = ["--set", f"train.end_iter={args.iters}",
               "--set", f"train.warm_up_iter={args.warmup}",
               "--set", "train.warm_up_end=500",
               "--set", "train.save_freq=5000",
               "--set", "train.val_freq=10000",
               "--set", "train.val_mesh_freq=10000",
               "--set", "train.report_freq=500"]
        r = run([sys.executable, "exp_runner.py", "--mode", "train_rnb",
                 "--conf", "confs/wmask_rnb.conf", "--case", args.case,
                 "--mesh_resolution", str(args.mesh_resolution)] + ovr)
        if r.returncode != 0:
            raise SystemExit(f"training failed rc={r.returncode}")
        trained = True

    # the analytic torus is IDENTICAL to the square-case one (R=0.5, r=0.22,
    # only translated), so the world-unit gate equals the r4 gate — the
    # scale_mat changes the training-internal representation, not the
    # object's physical size. The 512^3 grid does span the (larger)
    # normalized bbox, so cells are ~scale x coarser in world units; 0.004
    # leaves room for that.
    threshold = 0.004
    g = run([sys.executable, "tools/acceptance.py", exp_dir,
             "--shape", "torus", "--warm_up_iter", str(args.warmup),
             "--threshold", str(threshold),
             "--center", *[str(c) for c in CENTER]],
            capture_output=True, text=True)
    try:
        rec = json.loads(g.stdout.strip().splitlines()[-1])
    except (json.JSONDecodeError, IndexError):
        rec = {"accepted": False,
               "failures": [f"gate crashed: {g.stderr[-400:]}"]}
    if trained:
        rec["train_wall_s"] = round(time.time() - t0, 1)
    out = {
        "protocol": (f"{args.width}x{args.height} NON-SQUARE degraded torus "
                     f"at world center {CENTER}, scene-normalized by our own "
                     "preprocess_cameras.py (non-identity scale mats: "
                     f"scale {scale:.4f}, t {scale_mat[:3, 3].tolist()}), "
                     f"{args.iters} iters ({args.warmup} warm-up), "
                     f"{args.mesh_resolution}^3 WORLD-space extraction, "
                     "Chamfer-L1 in WORLD units vs the clean analytic torus"),
        "scale_mat_scale": scale,
        "scale_mat_t": [round(float(x), 5) for x in scale_mat[:3, 3]],
        "threshold_world": threshold,
        "wmask_rnb": rec,
        "all_accepted": bool(rec.get("accepted")),
    }
    with open(os.path.join(ROOT, args.out), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({"all_accepted": out["all_accepted"],
                      "out": args.out}), flush=True)
    return 0 if out["all_accepted"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
