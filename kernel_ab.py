"""Time the flash kernels' bf16 backward entries (B2's dK/dV and B3's dQ)
of several checkouts on one card, in one call.

    python3 kernel_ab.py BASE_DIR [OTHER_DIR ...]

Each directory is a checkout of the repository (for example the parent
commit unpacked with ``git archive <commit> | tar -x -C .parent``, and
``.`` for this one). Each run is a fresh process that imports
``paddle_tpu_torch`` from its checkout and builds that checkout's
kernels there, draws the AMP train step's attention inputs from one seed
(this checkout's ``chip_smoke.py``: bf16 q/k/v ``[64, 8, 256, 64]`` with
the source key mask, and causal), runs the checkout's bf16 forward for
the output and LSE, and times ``flash_bwd_dkv`` and ``flash_bwd_dq``
with ``chip_smoke.cuda_ms`` (CUDA-graph replays over three copies of the
inputs, larger together than the L2 cache). The runs go through the
checkouts in order and then back (A, B, ..., B, A), so that a drift of
the card's speed over the call falls on every side. Prints the card's
name and power limit, every run's times, and each checkout's mean of
its two runs. Needs one card; exits 1 without one.
"""

import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ENTRIES = ("flash_bwd_dkv", "flash_bwd_dq")
SHAPES = ("train_self_masked", "train_causal")


def run(root):
    """One run in this process: ``root``'s bf16 backward entries at the
    AMP train shapes. Prints one JSON line {"<entry> <shape>": ms}."""
    import importlib.util

    sys.path.insert(0, os.path.abspath(root))
    import torch

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import paddle_tpu_torch
    from paddle_tpu_torch.kernels import build as kbuild
    from paddle_tpu_torch.kernels import flash_attention as fa

    if os.path.dirname(os.path.abspath(paddle_tpu_torch.__file__)) != \
            os.path.join(os.path.abspath(root), "paddle_tpu_torch"):
        sys.exit("kernel_ab: imported %s, not %s's port"
                 % (paddle_tpu_torch.__file__, root))
    kbuild.build()
    kbuild.library()
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 20)
    cases = dict(cs.train_flash_cases(torch, gen))
    times = {}
    for shape in SHAPES:
        kw = {k: v.to(torch.bfloat16) if k in ("q", "k", "v") else v
              for k, v in cases[shape].items()}
        a = cs.bwd_inputs(torch, fa, kw, gen)
        a["dout"] = a["dout"].to(torch.bfloat16)
        delta = (a["dout"].float() * a["out"].float()).sum(dim=-1)
        kern = dict(q=a["q"], k=a["k"], v=a["v"], kv_mask=a["kv_mask"],
                    dout=a["dout"], lse=a["lse"], delta=delta,
                    causal=a["causal"], sm_scale=a["q"].shape[-1] ** -0.5)
        for entry in ENTRIES:
            times["%s %s" % (entry, shape)] = cs.cuda_ms(
                getattr(fa, entry), cs.copies(kern))
    print(json.dumps(times))


def main():
    if len(sys.argv) >= 3 and sys.argv[1] == "--run":
        run(sys.argv[2])
        return
    if len(sys.argv) < 2:
        sys.exit(__doc__)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: torch sees no CUDA device", file=sys.stderr)
        sys.exit(1)
    roots = sys.argv[1:]
    for root in roots:
        if not os.path.isdir(os.path.join(root, "paddle_tpu_torch")):
            sys.exit("kernel_ab: no paddle_tpu_torch/ in %s" % root)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print("card: %s" % card)
    order = list(range(len(roots))) + list(reversed(range(len(roots))))
    runs = {i: [] for i in range(len(roots))}
    for i in order:
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--run", roots[i]],
            capture_output=True, text=True, timeout=900)
        if out.returncode != 0:
            sys.exit("kernel_ab: the run of %s failed:\n%s"
                     % (roots[i], out.stderr[-4000:]))
        r = json.loads(out.stdout.strip().splitlines()[-1])
        runs[i].append(r)
        print("run %-24s %s" % (roots[i], "  ".join(
            "%s %.4f ms" % (k, v) for k, v in sorted(r.items()))))
    for i, root in enumerate(roots):
        keys = sorted(runs[i][0])
        print("mean %-23s %s" % (root, "  ".join(
            "%s %.4f ms" % (k, np.mean([r[k] for r in runs[i]]))
            for k in keys)))
    print(card)


if __name__ == "__main__":
    main()
