#!/usr/bin/env python3
"""X3, the SHVC inter-layer upsample kernel, on the card.

    python3 tools/x3_probe.py [--other DIR] [--no-check]

Prints ptxas's registers, shared memory and spills for
``openhevc_tpu_torch/csrc/upsample.cu``; then, in a process of its own for
each checkout (DIR first and last when given: other, this, this, other),
holds the kernel to its plain version on chip_smoke's whole-frame cases
(``check_x3``, unless --no-check) and times one 1920x1080 to 3840x2160
4:2:0 picture of seeded depth-8 samples with chip_smoke's ``time_x3``
(CUDA events, torch.profiler device time, the bound), one ``x3_probe``
JSON line a turn.  DIR is another checkout of the repo, for example the
parent commit unpacked by ``git archive``.  Needs one card and nvcc.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 13


def ptxas(root):
    """-> ptxas's lines for the kernels of csrc/upsample.cu in ``root``."""
    sys.path.insert(0, root)
    from openhevc_tpu_torch.torch_backend import cuda_lib
    src = os.path.join(cuda_lib.CSRC, "upsample.cu")
    with tempfile.TemporaryDirectory() as tmp:
        out = subprocess.run(
            [cuda_lib._nvcc()] + cuda_lib.FLAGS +
            ["-Xptxas", "-v", "-I", cuda_lib.CSRC, "-c", src, "-o",
             os.path.join(tmp, "upsample.o")],
            capture_output=True, text=True, check=True)
    return [ln.strip() for ln in (out.stdout + out.stderr).splitlines()
            if "ptxas" in ln or "stack frame" in ln]


def turn(root, check):
    """One checkout in this process: the checks, then one picture timed."""
    sys.path.insert(0, root)
    import numpy as np
    import torch
    import chip_smoke
    from openhevc_tpu_torch.torch_backend import cuda_lib
    cuda_lib.build()
    dev = torch.device("cuda")
    res = {"root": root}
    if check:
        res["check_x3_max_abs_err"] = chip_smoke.check_x3(
            np.random.default_rng(SEED), dev)
    rng = np.random.default_rng(SEED)
    planes = [torch.as_tensor(rng.integers(0, 256, s).astype(np.int32),
                              device=dev)
              for s in ((1080, 1920), (540, 960), (540, 960))]
    res.update(chip_smoke.time_x3(planes))
    print("x3_probe " + json.dumps(res, default=float), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", help="another checkout, timed in turns")
    ap.add_argument("--no-check", action="store_true")
    ap.add_argument("--turn", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.turn:
        turn(a.turn, not a.no_check)
        return
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    for ln in ptxas(ROOT):
        print(ln, flush=True)
    roots = [ROOT]
    if a.other:
        other = os.path.abspath(a.other)
        roots = [other, ROOT, ROOT, other]
    for root in roots:
        cmd = [sys.executable, os.path.abspath(__file__), "--turn", root]
        subprocess.run(cmd + (["--no-check"] if a.no_check else []),
                       check=True)


if __name__ == "__main__":
    main()
