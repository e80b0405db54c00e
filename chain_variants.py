#!/usr/bin/env python3
"""Times the chain kernels (``parsec_tpu_torch/csrc/gemm_chain.cu``) against
variants of their source, on one CUDA card.

    python3 chain_variants.py

Each variant is the source with a few text substitutions, built with the
same nvcc flags into ``parsec_tpu_torch/build/variants/``. Every variant's
output must equal the unchanged kernel's bit for bit before it is timed.
The libraries then take turns (base, variants, variants reversed, base)
at the main paths' shapes: ``gemm_chain`` bf16 at C 512^2, kt = 32 (the DTD
GEMM's task, split route) and ``matmul`` bf16 8192^3 (tile route). Device
time is CUDA events over back-to-back calls, as in ``chip_smoke.py``.

Variants:

* ``one slice in flight``: the consumers wait for the previous slice's
  wgmmas (``wgmma.wait_group 1``) instead of the current one's, and release
  its stage one slice later.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

VARIANTS = {
    "one slice in flight": [
        ("      for (int ks = 0; ks < nks; ++ks) {\n"
         "        mbar_wait(&full[stage], phase);",
         "      int held = -1;\n"
         "      for (int ks = 0; ks < nks; ++ks) {\n"
         "        mbar_wait(&full[stage], phase);"),
        ('        asm volatile("wgmma.wait_group.sync.aligned 0;\\n" ::: '
         '"memory");\n'
         "        if (lane == 0) mbar_arrive(&empty[stage]);",
         "        if (ks == nks - 1)\n"
         '          asm volatile("wgmma.wait_group.sync.aligned 0;\\n" ::: '
         '"memory");\n'
         "        else\n"
         '          asm volatile("wgmma.wait_group.sync.aligned 1;\\n" ::: '
         '"memory");\n'
         "        if (lane == 0 && held >= 0) mbar_arrive(&empty[held]);\n"
         "        held = stage;\n"
         "        if (ks == nks - 1) {\n"
         "          if (lane == 0) mbar_arrive(&empty[stage]);\n"
         "          held = -1;\n"
         "        }"),
    ],
}


def build_variant(K, name: str, subs) -> ctypes.CDLL:
    with open(os.path.join(K.CSRC_DIR, "gemm_chain.cu")) as f:
        src = f.read()
    for old, new in subs:
        if src.count(old) != 1:
            raise RuntimeError(f"variant {name!r}: the text to replace is not "
                               f"in the source once:\n{old}")
        src = src.replace(old, new)
    out = os.path.join(K.BUILD_DIR, "variants")
    os.makedirs(out, exist_ok=True)
    stem = os.path.join(out, name.replace(" ", "_"))
    with open(stem + ".cu", "w") as f:
        f.write(src)
    subprocess.run([K.nvcc_path(), *K.NVCC_FLAGS, "-o", stem + ".so",
                    stem + ".cu"], check=True)
    lib = ctypes.CDLL(stem + ".so")
    K._bind("gemm_chain", lib)
    return lib


def event_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chain_variants: no CUDA device", file=sys.stderr)
        return 1
    from parsec_tpu_torch.ops import cuda_kernels as K
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    libs = {"base": K._library("gemm_chain")}
    for name, subs in VARIANTS.items():
        libs[name] = build_variant(K, name, subs)
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16 = torch.bfloat16
    c = torch.randn(512, 512, device="cuda", generator=gen).to(bf16)
    a = torch.randn(32, 512, 512, device="cuda", generator=gen).to(bf16)
    b = torch.randn(32, 512, 512, device="cuda", generator=gen).to(bf16)
    x = torch.randn(8192, 8192, device="cuda", generator=gen).to(bf16)
    y = torch.randn(8192, 8192, device="cuda", generator=gen).to(bf16)
    cases = {
        "gemm_chain bf16 C 512^2 kt=32": (lambda: K.gemm_chain(c, a, b), 50),
        "matmul bf16 8192^3": (lambda: K.matmul(x, y), 5),
    }
    names = list(libs)
    order = names + names[1:][::-1] + names[:1]
    try:
        for case, (fn, iters) in cases.items():
            K._libs["gemm_chain"] = libs["base"]
            want = fn()
            for name in names[1:]:
                K._libs["gemm_chain"] = libs[name]
                if not torch.equal(fn(), want):
                    raise AssertionError(f"variant {name!r} changes the "
                                         f"output of {case}")
            for name in order:
                K._libs["gemm_chain"] = libs[name]
                print(f"{case}: {name}: {event_ms(torch, fn, iters):.4f} ms",
                      flush=True)
    finally:
        K._libs["gemm_chain"] = libs["base"]
    return 0


if __name__ == "__main__":
    sys.exit(main())
