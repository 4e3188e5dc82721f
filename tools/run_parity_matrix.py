#!/usr/bin/env python
"""Round-4 parity protocol: the full conf matrix on a DEGRADED synthetic
capture, each variant gated by Chamfer acceptance.

The reference's north-star claim is Chamfer parity on DiLiGenT-MV captures
whose normal/albedo inputs are noisy SDM-UniPS photometric-stereo estimates
(`/root/reference/models/dataset.py:141-151`, `README.md:84`). No DiLiGenT
data exists in this environment, so this protocol builds the strongest
available proxy (VERDICT r3 missing #1): the analytic torus capture degraded
like PS outputs (tools/make_synthetic_case.py --degrade: ~3 deg per-pixel
normal noise, +/-2 px mask morphology, 8-bit map quantization, +/-0.2%%
focal error), trained end-to-end on ALL FOUR canonical conf variants
(`/root/reference/confs/{wmask,womask}_rnb{,_noalbedo}.conf`):

    wmask            mask BCE 0.1, albedo supervision
    wmask_noalbedo   mask BCE 0.1, shading-only (color net frozen by
                     zero-grad, == reference param exclusion
                     `exp_runner.py:111-112`)
    womask           mask BCE 0, anneal_end 50000->5000 (scaled with the
                     10x-compressed schedule), n_outside=4 so the
                     background NeRF actually trains
    womask_noalbedo  both of the above

Each run: 30k iters (20k warm-up -- the reference's 2:1 ratio), 512^3
extraction, acceptance gate vs the CLEAN analytic torus (the degradation is
on the inputs only; the gate measures true surface error).

Usage: python tools/run_parity_matrix.py [--iters 30000] [--variants ...]
       [--out PARITY_r4.json] [--skip_existing]

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

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# thresholds: the clean-capture round-3 run measured Chamfer-L1 0.00134
# (docs/RUN_REPORT_r3.md). Degradation adds irreducible error: ~3 deg normal
# noise biases the synthesized supervision itself, +/-2 px mask morphology at
# 256^2 moves the silhouette by ~0.008 scene units locally, and +/-0.2% focal
# error shifts projections ~0.5 px. Gates are set at ~3x the clean result
# for the mask-supervised variants and 2x that for the womask variants
# (silhouette carving must come from color alone there, the method's known
# harder regime -- the reference compensates with anneal_end=50000).
# keys are the conf base_exp_dir leaf names (exp/<case>/<key>)
VARIANTS = {
    "wmask_rnb": {
        "conf": "confs/wmask_rnb.conf", "threshold": 0.004, "extra": []},
    "wmask_rnb_noalbedo": {
        "conf": "confs/wmask_rnb_noalbedo.conf", "threshold": 0.004,
        "extra": []},
    "womask_rnb": {
        "conf": "confs/womask_rnb.conf", "threshold": 0.008,
        "extra": ["--set", "train.anneal_end=5000",
                  "--set", "model.neus_renderer.n_outside=4"]},
    "womask_rnb_noalbedo": {
        "conf": "confs/womask_rnb_noalbedo.conf", "threshold": 0.008,
        "extra": ["--set", "train.anneal_end=5000",
                  "--set", "model.neus_renderer.n_outside=4"]},
}


def run(cmd, **kw):
    print("+", " ".join(cmd), flush=True)
    return subprocess.run(cmd, cwd=ROOT, **kw)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--case", default="torus_deg")
    ap.add_argument("--iters", type=int, default=30000)
    ap.add_argument("--warmup", type=int, default=20000)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--n_views", type=int, default=8)
    ap.add_argument("--variants", nargs="*", default=list(VARIANTS))
    ap.add_argument("--out", default="PARITY_r4.json")
    ap.add_argument("--mesh_resolution", type=int, default=512)
    ap.add_argument("--skip_existing", action="store_true",
                    help="keep finished exp dirs (gate-only re-run)")
    args = ap.parse_args(argv)

    data_dir = os.path.join(ROOT, "data", args.case)
    if not os.path.isdir(data_dir):
        run([sys.executable, "tools/make_synthetic_case.py", "--out",
             f"data/{args.case}", "--shape", "torus", "--degrade",
             "--n_views", str(args.n_views), "--size", str(args.size)],
            check=True)

    records = {}
    for name in args.variants:
        spec = VARIANTS[name]
        exp_dir = os.path.join(ROOT, "exp", args.case, name)
        t0 = time.time()
        trained = False
        if not (args.skip_existing and os.path.isdir(
                os.path.join(exp_dir, "meshes"))):
            if os.path.isdir(exp_dir):
                shutil.rmtree(exp_dir)
            ovr = ["--set", f"train.end_iter={args.iters}",
                   "--set", f"train.warm_up_iter={args.warmup}",
                   "--set", "train.warm_up_end=500",
                   "--set", "train.save_freq=5000",
                   "--set", "train.val_freq=10000",
                   "--set", "train.val_mesh_freq=10000",
                   "--set", "train.report_freq=500"] + spec["extra"]
            r = run([sys.executable, "exp_runner.py", "--mode", "train_rnb",
                     "--conf", spec["conf"], "--case", args.case,
                     "--mesh_resolution", str(args.mesh_resolution)] + ovr)
            if r.returncode != 0:
                records[name] = {"accepted": False,
                                 "failures": [f"training rc={r.returncode}"]}
                continue
            trained = True
        g = run([sys.executable, "tools/acceptance.py", exp_dir,
                 "--shape", "torus", "--warm_up_iter", str(args.warmup),
                 "--threshold", str(spec["threshold"])],
                capture_output=True, text=True)
        try:
            rec = json.loads(g.stdout.strip().splitlines()[-1])
        except (json.JSONDecodeError, IndexError):
            rec = {"accepted": False,
                   "failures": [f"gate crashed: {g.stderr[-400:]}"]}
        rec["variant"] = name
        rec["conf"] = spec["conf"]
        if trained:
            rec["train_wall_s"] = round(time.time() - t0, 1)
        print(json.dumps(rec), flush=True)
        records[name] = rec

    out = {
        "protocol": ("degraded synthetic torus (3deg normal noise, +/-2px "
                     "mask morphology, 8-bit maps, +/-0.2% focal error), "
                     f"{args.iters} iters ({args.warmup} warm-up), "
                     f"{args.mesh_resolution}^3 extraction, Chamfer-L1 vs "
                     "CLEAN analytic surface"),
        "all_accepted": all(r.get("accepted") for r in records.values()),
        "variants": records,
    }
    with open(os.path.join(ROOT, args.out), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({"all_accepted": out["all_accepted"],
                      "out": args.out}), flush=True)
    return 0 if out["all_accepted"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
