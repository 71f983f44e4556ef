"""Serving tokens/s of two checkouts of the repo in one run, in turns (not
a pytest file; needs a GPU):

    python3 tests/torch_serving_versus.py PARENT [--pairs 2]

PARENT is another checkout (e.g. the parent commit unpacked with git
archive). Each turn is a fresh process that imports one checkout's
ray_tpu_torch and serves chip_smoke.py serve_8b's config and waves through
its LLMServer (Llama-3-8B widths, 32 layers, bf16, seeded weights; 8
requests x 128 prompt ids x 48 new tokens a wave, decode_steps 8, each wave
admitted whole): one warm wave, then three timed. Turns run parent, this,
this, parent for each pair, so drift falls on both sides. Prints one JSON
line a turn and a summary line with each side's median.
"""

import argparse
import json
import os
import subprocess
import sys
import threading
import time

THIS = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def turn(checkout):
    """One turn, in this process, over ``checkout``'s package."""
    sys.path.insert(0, checkout)
    import numpy as np
    import torch

    from ray_tpu_torch import native
    from ray_tpu_torch.llm import LLMServer

    if os.path.dirname(os.path.dirname(os.path.dirname(
            native.__file__))) != checkout:
        raise RuntimeError(f"imported {native.__file__}, not {checkout}")
    native.build_all()
    n_req, prompt_len, max_tokens = 8, 128, 48
    srv = LLMServer({"model": "llama3-8b", "seed": 0, "engine_config": {
        "max_seqs": 8, "page_size": 64, "max_pages_per_seq": 8,
        "decode_steps": 8}}, device="cuda")
    rng = np.random.default_rng(0)

    def wave():
        prompts = [rng.integers(0, 128256, prompt_len).tolist()
                   for _ in range(n_req)]
        res = [None] * n_req

        def go(i):
            res[i] = srv.generate_all(prompts[i], max_tokens=max_tokens)

        threads = [threading.Thread(target=go, args=(i,))
                   for i in range(n_req)]
        t = time.perf_counter()
        with srv.paused():
            for th in threads:
                th.start()
            while srv.stats()["pending"] < n_req:
                time.sleep(0.001)
        for th in threads:
            th.join(600)
        return sum(len(r["tokens"]) for r in res) / (time.perf_counter() - t)

    try:
        wave()
        tps = [wave() for _ in range(3)]
    finally:
        srv.shutdown()
    torch.cuda.synchronize()
    print(json.dumps({"checkout": checkout, "tokens_per_s": tps,
                      "median": float(np.median(tps))}), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent")
    ap.add_argument("--pairs", type=int, default=2)
    ap.add_argument("--turn", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.turn:
        return turn(args.turn)
    parent = os.path.abspath(args.parent)
    order = [parent, THIS, THIS, parent] * args.pairs
    got = {parent: [], THIS: []}
    for checkout in order:
        out = subprocess.run([sys.executable, __file__, parent, "--turn",
                              checkout], capture_output=True, text=True,
                             timeout=900)
        if out.returncode:
            print(out.stderr[-4000:], file=sys.stderr)
            return out.returncode
        row = json.loads(out.stdout.strip().splitlines()[-1])
        print(json.dumps(row), flush=True)
        got[checkout].append(row["median"])
    import statistics

    print(json.dumps({"parent_medians": got[parent],
                      "this_medians": got[THIS],
                      "parent": statistics.median(got[parent]),
                      "this": statistics.median(got[THIS])}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
