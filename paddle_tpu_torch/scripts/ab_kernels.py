"""Time the decode-attention kernels of two checkouts on one card.

    python -m paddle_tpu_torch.scripts.ab_kernels OTHER_CHECKOUT

Runs ``chip_smoke.py``'s kernel checks (``check_decode_kernel`` at H =
Hkv, and ``check_paged_kernels`` where the checkout has it) in a fresh
process per run, each building its checkout's kernels, in the order
other, this, this, other, repeated ``ROUNDS`` times: kernel times move
between processes on one card, so two checkouts are compared only
alternating within one call.  Prints one JSON line per run with the
kernel times in ms.  Needs a CUDA device.
"""

import json
import os
import subprocess
import sys

ROUNDS = 2

_RUN = r'''
import json, numpy as np, torch
import chip_smoke as cs
dev, rng = torch.device("cuda"), np.random.RandomState(0)
ms = {"decode_attention_slab_chunk":
      cs.check_decode_kernel(torch, dev, rng, cs.HEADS)["ms"]}
if hasattr(cs, "check_paged_kernels"):
    rows = cs.check_paged_kernels(torch, dev, rng, cs.HEADS)
    ms.update({name: row["ms"] for name, row in rows.items()})
print(json.dumps(ms))
'''


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        raise SystemExit(__doc__)
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    trees = {"other": os.path.abspath(argv[0]), "this": here}
    for _ in range(ROUNDS):
        for name in ("other", "this", "this", "other"):
            r = subprocess.run([sys.executable, "-c", _RUN], cwd=trees[name],
                               capture_output=True, text=True, timeout=600)
            if r.returncode:
                raise SystemExit(f"{name} ({trees[name]}) failed:\n"
                                 f"{r.stderr[-4000:]}")
            print(json.dumps({"checkout": name, "ms": json.loads(
                r.stdout.strip().splitlines()[-1])}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
