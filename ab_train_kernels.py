#!/usr/bin/env python3
"""Device time of K5's and K6's backward kernels for two checkouts of the
repo, alternating on one GPU: A, B, B, A.

    python3 ab_train_kernels.py TREE_A TREE_B

Each pass runs in a fresh process with ``TREE/src`` on its path (the
tree's own kernels, built into ``TREE/build`` at first use) and times, as
``chip_smoke.py`` phase 9a does (CUDA-graph replays, the median of 7
rounds of 100), ``flash_attention_bwd`` at the shapes 9a times (the
architectures of ``BWD_ARCHS``, 9f's ``encdec_bwd_shapes`` and 9e's
windowed ``window_bwd_shape``; bf16, o and the log-sum-exp from the
tree's forward kernel) and ``rmsnorm_bwd`` at qwen3-14b's norm rows
([1024, 5120] and [40960, 128], bf16). The shapes and the timer come from
this checkout's ``chip_smoke.py``, the kernels from each tree. Prints one
JSON line per pass and, last, the mean of each tree's two passes per
shape with the card's name and power limit. Run it from the repo root on
a machine with one CUDA GPU, e.g. with the parent commit unpacked into a
gitignored directory:

    git archive HEAD~1 | (mkdir -p build/ab/parent && tar -x -C build/ab/parent)
    python3 ab_train_kernels.py build/ab/parent .
"""
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))


def child(tree: str) -> dict:
    """One pass in this process over ``tree``'s kernels."""
    sys.path[:0] = [os.path.join(tree, "src"), ROOT,
                    os.path.join(ROOT, "tests")]
    import torch
    import chip_smoke as cs
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)
    from repro_torch.kernels.rmsnorm import rmsnorm_bwd
    dev = "cuda"
    shapes = {}
    for arch, cfg in cs.arch_cfgs(cs.BWD_ARCHS):
        sh, norms = cs.train_kernel_shapes(arch, cfg)
        shapes[arch] = sh[:6] + (True, 0)
        if arch == "qwen3_14b":
            rows = {tag: norms[tag] for tag in ("ln", "q")}
    for what, sh in cs.encdec_bwd_shapes().items():
        shapes[what] = sh[:7] + (0,)
    B, H, KV, T, S, D, w, _ = cs.window_bwd_shape()
    shapes["recurrentgemma_2b window"] = (B, H, KV, T, S, D, True, w)
    out = {}
    for what, (B, H, KV, T, S, D, causal, w) in shapes.items():
        q, k, v, do = (a.to(torch.bfloat16) for a in cs.card_normal(
            torch, dev, T + S + D, (B, H, T, D), (B, KV, S, D),
            (B, KV, S, D), (B, H, T, D)))
        o, lse = flash_attention(q, k, v, causal=causal, window=w,
                                 return_lse=True)
        out[f"flash_attention_bwd {what} q {[B, H, T, D]} k/v "
            f"{[B, KV, S, D]}"] = cs.graph_ms(
                torch, lambda: flash_attention_bwd(
                    q, k, v, o, lse, do, causal=causal, window=w)) * 1e3
    for tag, (N, Dn) in rows.items():
        x, s, dy = cs.card_normal(torch, dev, N + Dn, (N, Dn), (Dn,),
                                  (N, Dn))
        x, dy, s = (3.0 * x).to(torch.bfloat16), dy.to(torch.bfloat16), \
            1.0 + 0.1 * s
        out[f"rmsnorm_bwd {tag} [{N}, {Dn}]"] = cs.graph_ms(
            torch, lambda: rmsnorm_bwd(x, s, dy)) * 1e3
    return out


def main():
    args = sys.argv[1:]
    if args and args[0] == "--child":
        print(json.dumps(child(args[1])), flush=True)
        return
    if len(args) != 2:
        sys.exit(__doc__)
    import torch
    if not torch.cuda.is_available():
        sys.exit("ab_train_kernels.py: CUDA is not available")
    trees = [os.path.abspath(t) for t in args]
    for t in trees:
        if not os.path.isdir(os.path.join(t, "src", "repro_torch")):
            sys.exit(f"ab_train_kernels.py: {t} holds no src/repro_torch")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    passes = {0: [], 1: []}
    for i in (0, 1, 1, 0):
        res = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child", trees[i]],
            capture_output=True, text=True, timeout=1200)
        if res.returncode:
            sys.stderr.write(res.stderr[-4000:])
            sys.exit(f"ab_train_kernels.py: the pass over {trees[i]} failed")
        got = json.loads(res.stdout.strip().splitlines()[-1])
        passes[i].append(got)
        print(json.dumps({"tree": args[i], "us": got}), flush=True)
    summary = {}
    for key in passes[0][0]:
        a, b = (sum(p[key] for p in passes[i]) / 2 for i in (0, 1))
        summary[key] = dict(us_a=a, us_b=b, a_over_b=a / b)
    print(smi, flush=True)
    print(json.dumps({"trees": args, "device": smi, "us": summary}),
          flush=True)


if __name__ == "__main__":
    main()
