"""Time the port's Transformer-base train step in two checkouts, on one
card, in one call.

    python3 train_step_ab.py PARENT_DIR [CHANGE_DIR]

``CHANGE_DIR`` defaults to the directory of this script. Each run is a
fresh process that imports ``paddle_tpu_torch`` from its checkout (and
builds that checkout's kernels there), builds ``chip_smoke.py``'s train
program (Transformer-base as bench.py trains it: batch 64 x 256,
dropout 0.1, label smoothing 0.1, ``Adam(2e-4)``, fp32, TF32 off), runs
its startup program and 2 warm-up steps, collects the heap's garbage and
freezes the survivors (``gc.freeze()``, as ``chip_smoke.py``'s train
phase does), times 20 steps, then unfreezes the heap and times 20 more
(where CPython's full collections walk the whole heap again). The runs
go parent, change, change, parent, so that a drift of the host's speed
over the call falls on both sides. Prints the card's name and power
limit, per run and window the mean, median, min and max step ms and the
pause of each generation-2 collection, and the mean frozen step of each
checkout over its two runs.
Needs one card; exits 1 without one.
"""

import gc
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
RUNS = ("parent", "change", "change", "parent")


def run(root):
    """One run in this process: the train steps of ``root``'s port.
    Prints one JSON line."""
    import importlib.util

    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch

    # this checkout's chip_smoke.py builds the program for both sides
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.kernels import build as kbuild

    if os.path.dirname(os.path.abspath(fluid.__file__)) != os.path.join(
            os.path.abspath(root), "paddle_tpu_torch"):
        sys.exit("train_step_ab: imported %s, not %s's port"
                 % (fluid.__file__, root))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kbuild.build()
    kbuild.library()
    main, startup, loss, _ = cs.build_train(fluid, cs.DROPOUT)
    exe = fluid.Executor()
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    feed = cs.train_feed(np, cs.TRAIN_BATCH)
    for _ in range(cs.TRAIN_WARMUP):
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    torch.cuda.synchronize()
    full = []  # (start, pause ms) of each generation-2 collection
    t_gc = [0.0]

    def on_gc(phase, info):
        if info["generation"] != 2:
            return
        if phase == "start":
            t_gc[0] = time.perf_counter()
        else:
            full.append((time.perf_counter() - t_gc[0]) * 1e3)

    gc.callbacks.append(on_gc)
    windows = {}
    for label in ("frozen", "unfrozen"):
        if label == "frozen":
            gc.collect()
            gc.freeze()
        else:
            gc.unfreeze()
        del full[:]
        step_ms, losses = [], []
        for _ in range(cs.TRAIN_STEPS):
            t0 = time.perf_counter()
            (lv,) = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(np.asarray(lv).reshape(-1)[0]))
        if not np.isfinite(losses).all():
            sys.exit("train_step_ab: a loss is not finite: %s" % losses)
        windows[label] = dict(step_ms=step_ms, full_ms=list(full),
                              first_loss=losses[0], last_loss=losses[-1])
    windows["objects"] = len(gc.get_objects())
    print(json.dumps(windows))


def main():
    if len(sys.argv) >= 3 and sys.argv[1] == "--run":
        run(sys.argv[2])
        return
    if len(sys.argv) not in (2, 3):
        sys.exit(__doc__)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("train_step_ab: torch sees no CUDA device", file=sys.stderr)
        sys.exit(1)
    roots = dict(parent=sys.argv[1],
                 change=sys.argv[2] if len(sys.argv) == 3 else HERE)
    for root in roots.values():
        if not os.path.isdir(os.path.join(root, "paddle_tpu_torch")):
            sys.exit("train_step_ab: no paddle_tpu_torch/ in %s" % root)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print("card: %s" % card)
    means = {k: [] for k in roots}
    for label in RUNS:
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--run",
             roots[label]], capture_output=True, text=True, timeout=900)
        if out.returncode != 0:
            sys.exit("train_step_ab: the %s run failed:\n%s"
                     % (label, out.stderr[-4000:]))
        r = json.loads(out.stdout.strip().splitlines()[-1])
        for window in ("frozen", "unfrozen"):
            w = r[window]
            ms = w["step_ms"]
            if window == "frozen":
                means[label].append(float(np.mean(ms)))
            print("%-6s %-8s %s: %d steps, mean %.1f ms (median %.1f, min "
                  "%.1f, max %.1f), generation-2 collections %s ms, loss "
                  "%.6f -> %.6f"
                  % (label, window, roots[label], len(ms), np.mean(ms),
                     np.median(ms), min(ms), max(ms),
                     ["%.1f" % t for t in w["full_ms"]], w["first_loss"],
                     w["last_loss"]))
        print("%-6s %d objects tracked by the garbage collector"
              % (label, r["objects"]))
    print("mean frozen step: parent %.1f ms, change %.1f ms (%+.1f %%)"
          % (np.mean(means["parent"]), np.mean(means["change"]),
             100.0 * (np.mean(means["change"]) / np.mean(means["parent"])
                      - 1.0)))
    print(card)


if __name__ == "__main__":
    main()
