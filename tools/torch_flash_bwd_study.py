#!/usr/bin/env python3
"""The design choices of ``paddle_tpu_torch/kernels/csrc/
flash_attention_bwd.cu`` against alternatives, on one NVIDIA card. Run
from the root of a checkout:

    python3 tools/torch_flash_bwd_study.py

It builds the committed source and five variants made from it by text
substitution, each with ``nvcc`` into ``build/flash_bwd_study/``:

- ``cvt_rna``: the 3xTF32 split through ``cvt.rna.tf32.f32`` (hi =
  cvt(x), lo = cvt(x - hi)) instead of the source's integer rounding;
- ``mma_accumulator``: the long sums (dk and dv over the queries, dq
  over the keys) left in the mma accumulators for the whole walk
  instead of a float32 add after each group of steps;
- ``tf32_once``: one TF32 product a float32 one (hi * hi) instead of
  three, so the split's lo halves go unused: not float32-exact (its
  errors are ~1e-3), timed to show what the 3xTF32 scheme costs;
- ``bn64``: streamed tiles of 64 rows instead of 32 (timed at D 64; the
  D 128 templates spill at this size);
- ``planes``: the dK/dV kernel's q and dO tiles split once as they land,
  into hi (in place) and lo planes in shared memory that the fragment
  loads then read, instead of each warp splitting every fragment it
  loads (the dQ kernel as in the source).

For each it prints the registers and spills ``-Xptxas -v`` reports, the
largest error of dq, dk and dv over the largest magnitude of a float64
plain backward at causal S 1024 (B 8, H 12, D 64: the LM step's shape)
and S 2048 (B 2, H 4), and at S 1024 the CUDA-event median time of each
kernel over 20 launches, L2 flushed before each. The last lines are the
card's name and power limit and one JSON object with all of it. Exits
non-zero without a card, or if the source no longer has the text a
variant replaces.
"""
import ctypes
import json
import os
import re
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from paddle_tpu_torch.kernels import _build  # noqa: E402
from paddle_tpu_torch.kernels import flash_attention as fa  # noqa: E402

OUT_DIR = os.path.join(ROOT, "build", "flash_bwd_study")
NAME = "flash_attention_bwd"

INT_SPLIT = """  const uint32_t r = __float_as_uint(x) + 0x1000u;
  hi = r;
  lo = __float_as_uint(x - __uint_as_float(r & 0xffffe000u));
"""
CVT_SPLIT = """  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(hi) : "f"(x));
  const float rest = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(lo) : "f"(rest));
"""
PLANE_LOADS = """// B fragments read from a tile already split into hi and lo planes
template <int LD>
__device__ __forceinline__ FragB load_b_t2(const float* hi, const float* lo,
                                           int g, int t) {
  FragB f;
  f.hi[0] = __float_as_uint(hi[g * LD + t]);
  f.lo[0] = __float_as_uint(lo[g * LD + t]);
  f.hi[1] = __float_as_uint(hi[g * LD + t + 4]);
  f.lo[1] = __float_as_uint(lo[g * LD + t + 4]);
  return f;
}
template <int LD>
__device__ __forceinline__ FragB load_b_perm2(const float* hi,
                                              const float* lo, int g, int t) {
  FragB f;
  f.hi[0] = __float_as_uint(hi[2 * t * LD + g]);
  f.lo[0] = __float_as_uint(lo[2 * t * LD + g]);
  f.hi[1] = __float_as_uint(hi[(2 * t + 1) * LD + g]);
  f.lo[1] = __float_as_uint(lo[(2 * t + 1) * LD + g]);
  return f;
}

// -- asynchronous copies"""
PLANE_SPLIT = """    const float* dlt = dls + (it & 1) * BN;
    // split the landed q and dO tiles once: hi in place, lo beside
    for (int i = threadIdx.x; i < BN * D; i += THREADS) {
      const int e = (i / D) * LD + i % D;
      uint32_t hi, lo;
      split(qt[e], hi, lo);
      const_cast<float*>(qt)[e] = __uint_as_float(hi);
      qlo[e] = __uint_as_float(lo);
      split(dot[e], hi, lo);
      const_cast<float*>(dot)[e] = __uint_as_float(hi);
      dolo[e] = __uint_as_float(lo);
    }
    __syncthreads();
"""
# (text in the source, text in the variant)
VARIANTS = {
    "cvt_rna": [(INT_SPLIT, CVT_SPLIT)],
    "tf32_once": [("  mma_tf32(d, a.lo, b.hi);\n  mma_tf32(d, a.hi, b.lo);\n",
                   "")],
    "mma_accumulator": [
        ("      float cv[4] = {0.f, 0.f, 0.f, 0.f}, "
         "ck[4] = {0.f, 0.f, 0.f, 0.f};\n",
         "      float (&cv)[4] = dva[dn], (&ck)[4] = dka[dn];\n"),
        ("      add4(dva[dn], cv);\n      add4(dka[dn], ck);\n", ""),
        ("      float c[4] = {0.f, 0.f, 0.f, 0.f};\n",
         "      float (&c)[4] = dqa[dn];\n"),
        ("      add4(dqa[dn], c);\n", ""),
    ],
    "bn64": [("constexpr int BN = 32; ", "constexpr int BN = 64; ")],
    "planes": [
        ("\n// -- asynchronous copies", "\n" + PLANE_LOADS),
        ("  return ((2 * BR + 4 * BN) * (D + 4) + 4 * BN) * 4;",
         "  return ((2 * BR + 6 * BN) * (D + 4) + 4 * BN) * 4;"),
        ("  float* dls = ls + 2 * BN;         // [2][BN]\n",
         "  float* dls = ls + 2 * BN;         // [2][BN]\n"
         "  float* qlo = dls + 2 * BN;\n  float* dolo = qlo + BN * LD;\n"),
        ("    const float* dlt = dls + (it & 1) * BN;\n", PLANE_SPLIT),
        ("load_b_t<LD>(qt + n * 8 * LD + kk * 8, g, t)",
         "load_b_t2<LD>(qt + n * 8 * LD + kk * 8, qlo + n * 8 * LD + kk * 8,"
         " g, t)"),
        ("load_b_t<LD>(dot + n * 8 * LD + kk * 8, g, t)",
         "load_b_t2<LD>(dot + n * 8 * LD + kk * 8, dolo + n * 8 * LD + "
         "kk * 8, g, t)"),
        ("load_b_perm<LD>(dot + off, g, t)",
         "load_b_perm2<LD>(dot + off, dolo + off, g, t)"),
        ("load_b_perm<LD>(qt + off, g, t)",
         "load_b_perm2<LD>(qt + off, qlo + off, g, t)"),
    ],
}


def variant_sources():
    with open(os.path.join(_build.CSRC_DIR, NAME + ".cu")) as f:
        src = f.read()
    out = {"source": src}
    for name, edits in VARIANTS.items():
        s = src
        for old, new in edits:
            if s.count(old) != 1:
                sys.exit("torch_flash_bwd_study: the source no longer has "
                         "the text variant %s replaces: %r" % (name, old))
            s = s.replace(old, new)
        out[name] = s
    return out


def ptxas_summary(log):
    """{kernel template: 'N registers[, spills]'} from nvcc -Xptxas -v."""
    out, cur = {}, None
    for ln in log.splitlines():
        m = re.search(r"flash_bwd_(dkv|dq)_kernelILi(\d+)E", ln)
        if "Compiling entry function" in ln and m:
            cur = "%s_D%s" % m.groups()
        elif cur and "registers" in ln:
            regs = re.search(r"Used (\d+) registers", ln).group(1)
            out[cur] = regs + " registers" + out.get(cur, "")
        elif cur and "spill" in ln and "0 bytes spill stores" not in ln:
            out[cur] = out.get(cur, "") + ", " + ln.strip()
    return out


def build(sources):
    os.makedirs(OUT_DIR, exist_ok=True)
    procs = {}
    for name, src in sources.items():
        path = os.path.join(OUT_DIR, name + ".cu")
        with open(path, "w") as f:
            f.write(src)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", path[:-3] + ".so",
             path], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    libs, ptxas = {}, {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            sys.exit("torch_flash_bwd_study: nvcc failed on %s:\n%s"
                     % (name, log))
        lib = ctypes.CDLL(os.path.join(OUT_DIR, name + ".so"))
        lib.error_string.argtypes = [ctypes.c_int]
        lib.error_string.restype = ctypes.c_char_p
        libs[name], ptxas[name] = lib, ptxas_summary(log)
    return libs, ptxas


def time_ms(fn, flush, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def main():
    if not torch.cuda.is_available():
        sys.exit("torch_flash_bwd_study: needs a CUDA device")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    libs, ptxas = build(variant_sources())
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    load = _build.load
    rng = np.random.RandomState(0)
    result = {name: {"ptxas": ptxas[name]} for name in libs}
    for B, S, H, D in ((8, 1024, 12, 64), (2, 2048, 4, 64)):
        q, k, v, do = [torch.from_numpy(rng.randn(B, S, H, D).astype(
            np.float32)).to(dev) for _ in range(4)]
        o, lse = fa.flash_attention_reference(q, k, v, causal=True)
        want = fa.flash_attention_bwd_reference(
            *(t.double() for t in (q, k, v, o, lse, do)), causal=True)
        delta = fa._delta(o, do, None).contiguous()
        for name, lib in libs.items():
            _build.load = (lambda n, lib=lib:
                           lib if n == NAME else load(n))
            try:
                got = fa.flash_attention_bwd(q, k, v, o, lse, do,
                                             causal=True)
                torch.cuda.synchronize()
                rec = {n: float((g.double() - w).abs().max()
                                / w.abs().max())
                       for n, g, w in zip(("dq", "dk", "dv"), got, want)}
                if S == 1024:
                    args = (q, k, v, do, lse, delta, True, D ** -0.5)
                    rec["dkv_ms"] = time_ms(lambda: fa._bwd_dkv(*args),
                                            flush)
                    rec["dq_ms"] = time_ms(lambda: fa._bwd_dq(*args), flush)
            finally:
                _build.load = load
            result[name]["S%d" % S] = rec
            print(json.dumps({name: {"S%d" % S: rec}}), flush=True)
        del q, k, v, do, o, lse, want, delta
        torch.cuda.empty_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    print(card[0] if card else "")
    print(json.dumps({"flash_bwd_study": result}))


if __name__ == "__main__":
    main()
