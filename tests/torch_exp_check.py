"""Is torch's first multi-threaded float32 exp on the CPU right, process by
process? The fault behind the once-flaky K1 parity test.

    JAX_PLATFORMS=cpu python tests/torch_exp_check.py [--runs 40] [--threads 4]

Each run is a fresh process on the inputs of
tests/test_torch_attention.py::test_plain_flash_out_and_lse_match_pallas_kernel
[True-4] (q, k [2, 128, 4, 32], seed 0): it builds the causal scores s as
flash_attention_fwd_plain does and takes exp(s - rowmax) first with one
function (``--first``), then with torch.exp again. It prints, for each
first function, in how many processes the first call and the second call
had an element more than 1e-6 away from float64's exp.
"""

import argparse
import json
import math
import os
import subprocess
import sys

FIRST = ("torch.exp", "exp_f32")


def child(first: str, threads: int) -> dict:
    import numpy as np
    import torch

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from ray_tpu_torch.ops.attention import exp_f32

    torch.set_num_threads(threads)
    rng = np.random.default_rng(0)
    q, k = (torch.from_numpy(rng.standard_normal((2, 128, 4, 32),
                                                 dtype=np.float32))
            for _ in range(2))
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * (1 / math.sqrt(32))
    ids = torch.arange(128)
    s = torch.where(ids[None, :] <= ids[:, None], s, -1e30)
    x = s - s.amax(dim=-1, keepdim=True)
    fn = torch.exp if first == "torch.exp" else exp_f32
    p_first = fn(x)
    p_again = torch.exp(x)
    ref = torch.exp(x.double())

    def wrong(p):
        return bool((p.double() - ref).abs().max() > 1e-6)

    return {"first": first, "first_wrong": wrong(p_first),
            "again_wrong": wrong(p_again)}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=40)
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--child", choices=FIRST)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child(args.child, args.threads)))
        return
    for first in FIRST:
        rows = [json.loads(subprocess.run(
            [sys.executable, __file__, "--child", first, "--threads",
             str(args.threads)], capture_output=True, text=True,
            check=True).stdout) for _ in range(args.runs)]
        print(json.dumps({
            "first": first, "runs": args.runs, "threads": args.threads,
            "first_call_wrong": sum(r["first_wrong"] for r in rows),
            "second_call_wrong": sum(r["again_wrong"] for r in rows)}))


if __name__ == "__main__":
    main()
