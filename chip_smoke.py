#!/usr/bin/env python3
"""Chip smoke of paddle_tpu_torch on one NVIDIA card (an H100).

Drives the port's generative serving path at the widths of GPT-2 small
and holds each hand-written CUDA kernel against its plain PyTorch
version. Run from the root of a checkout:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero at once:

1. build: compile every ``paddle_tpu_torch/kernels/csrc/*.cu`` with nvcc
   (one process per source, all started together);
2. kernels: each kernel against its plain version on the card, at the
   shapes the main path gives it, with the time of the kernel, of the
   plain version and of one PyTorch library call computing the same
   function, and the least time the card could take;
3. engine: export random GPT-2-small-wide weights (seed 0) as a
   generative artifact, load them onto the card, and serve 16 greedy
   requests (prompts of 16 to 900 tokens, 32 new tokens each) through
   the continuous-batching engine; the launch counters must show that
   every prefill and decode step went through the kernels, and two
   requests' logits, step by step, must agree with the plain
   full-sequence forward;
4. http: serve the same artifact on port 0 in-process, POST ``:generate``
   twice (tokens must equal the engine's), then raise SIGTERM while a
   third request is in flight: the server must drain it and answer.

The last lines printed are the card's name and power limit (as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
them), the ``{"kernels": [...]}`` line, and then
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
package beside it, the script exits non-zero and prints no result.
"""
import argparse
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import torch

# published peaks of one H100 SXM (NVIDIA data sheet): HBM3 bytes/s and
# float32 flops/s outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12

# GPT-2 small widths (Radford et al. 2019; Hugging Face "gpt2" config)
GPT2_SMALL = dict(vocab_size=50257, hidden=768, num_layers=12, num_heads=12,
                  ffn_mult=4, max_seq=1024)

# Kernel against plain version, same inputs, both float32 on the card:
# only the order of the float32 sums differs (online vs dense softmax,
# other reduction trees), worth ~1e-6 on outputs of size ~1. Rounding the
# inputs of the products to TF32 (10-bit mantissa) errs by ~1e-3.
KERNEL_TOL = 5e-5
# Logits of the kernel path (prefill and decode steps) against the plain
# full-sequence forward: the same sum-order differences carried through
# 12 layers. A forward whose attention inputs are rounded to TF32 (what a
# TF32 kernel computes) is measured in the same run and must miss this
# tolerance, so a kernel run in TF32 or bf16 would fail it.
LOGIT_TOL = 1e-3


def log(msg):
    print(msg, flush=True)


def fail(msg):
    print("chip_smoke: FAIL: %s" % msg, file=sys.stderr, flush=True)
    sys.exit(1)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[torch.cuda.current_device()] if out else ""


def time_ms(fn, iters=20, warmup=3, flush=None):
    """Median ms of ``fn`` over ``iters`` launches, each between its own
    CUDA events; ``flush`` (a large tensor) is zeroed before each launch
    so that no input is served from the 50 MB L2 of the previous one."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        if flush is not None:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def bound(nbytes, flops):
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -- phase 1 -----------------------------------------------------------------

def phase_build():
    from paddle_tpu_torch.kernels import _build
    t0 = time.monotonic()
    took = _build.build_all()
    total = time.monotonic() - t0
    for name in _build.sources():
        _build.load(name)
        ptxas = [ln.strip() for ln in (_build.build_log(name) or "")
                 .splitlines() if "registers" in ln or "spill" in ln]
        log("build %s: %s" % (name, " | ".join(ptxas)))
    log(json.dumps({"build": {"seconds": round(total, 3),
                              "per_source_s": {k: round(v, 3)
                                               for k, v in took.items()}}}))


# -- phase 2 -----------------------------------------------------------------

def _paged_inputs(dev):
    R, MB, T, nh, dh = 16, 64, 16, 12, 64
    P = R * MB
    rng = np.random.RandomState(11)
    kp = torch.from_numpy(rng.randn(P + 1, T, nh, dh).astype(np.float32))
    vp = torch.from_numpy(rng.randn(P + 1, T, nh, dh).astype(np.float32))
    q = torch.from_numpy(rng.randn(R, nh, dh).astype(np.float32))
    tables = rng.permutation(P).reshape(R, MB).astype(np.int32)
    positions = rng.randint(0, MB * T, (R,)).astype(np.int32)
    positions[:4] = [0, T - 1, T, MB * T - 1]
    tables[-2:] = P                      # two inactive rows: all trash
    positions[-2:] = 0
    return [t.to(dev) for t in (q, kp, vp, torch.from_numpy(tables),
                                torch.from_numpy(positions))]


def phase_kernels(dev):
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import paged_attention as pa
    F = torch.nn.functional
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    out = {}

    # paged attention, the decode step's shape: R=16, MB=64, T=16, nh=12
    q, kp, vp, tables, positions = _paged_inputs(dev)
    R, nh, dh = q.shape
    T, MB = kp.shape[1], tables.shape[1]
    got = pa.paged_attention(q, kp, vp, tables, positions)
    want = pa.paged_attention_reference(q, kp, vp, tables, positions)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if not np.isfinite(err) or err > KERNEL_TOL:
        fail("paged_attention disagrees with its plain version: max abs "
             "err %g > %g" % (err, KERNEL_TOL))
    cols = (torch.clamp(positions.long(), max=MB * T - 1) + 1).sum().item()
    nbytes = (cols * nh * dh * 2 * 4 + 2 * R * nh * dh * 4 + R * 4
              + int(((positions.long().clamp(max=MB * T - 1) // T) + 1)
                    .sum()) * 4)
    b_ms, b_by = bound(nbytes, 4 * cols * nh * dh)
    colmask = (torch.arange(MB * T, device=dev)[None, :]
               <= positions.long()[:, None])[:, None, None, :]

    def library():
        kc = kp[tables.long()].reshape(R, MB * T, nh, dh).transpose(1, 2)
        vc = vp[tables.long()].reshape(R, MB * T, nh, dh).transpose(1, 2)
        return F.scaled_dot_product_attention(q[:, :, None, :], kc, vc,
                                              attn_mask=colmask)

    lib_err = float((library()[:, :, 0] - want).abs().max())
    out["paged_attention"] = {
        "name": "paged_attention", "route": "cuda",
        "source": "paddle_tpu_torch/kernels/csrc/paged_attention.cu",
        "replaces": "paddle_tpu/kernels/paged_attention.py:154",
        "max_abs_err": err, "tolerance": KERNEL_TOL,
        "ms": time_ms(lambda: pa.paged_attention(q, kp, vp, tables,
                                                  positions), flush=flush),
        "plain_ms": time_ms(lambda: pa.paged_attention_reference(
            q, kp, vp, tables, positions), flush=flush),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": time_ms(library, flush=flush),
        "library": "gather + scaled_dot_product_attention",
        "library_max_abs_err": lib_err,
        "shape": {"R": R, "MB": MB, "T": T, "nh": nh, "dh": dh,
                  "positions": positions.tolist()}}

    # flash forward, the prefill's shape: causal, [1, S, 12, 64]
    rng = np.random.RandomState(12)
    shapes, errs = {}, []
    for S in (17, 128, 1024):
        qkv = [torch.from_numpy(rng.randn(1, S, 12, 64).astype(np.float32)
                                ).to(dev) for _ in range(3)]
        o, lse = fa.flash_attention_with_lse(*qkv, causal=True)
        o_ref, lse_ref = fa.flash_attention_reference(*qkv, causal=True)
        torch.cuda.synchronize()
        e = max(float((o - o_ref).abs().max()),
                float((lse - lse_ref).abs().max()))
        if not np.isfinite(e) or e > KERNEL_TOL:
            fail("flash_attention_fwd disagrees with its plain version at "
                 "S=%d: max abs err %g > %g" % (S, e, KERNEL_TOL))
        errs.append(e)
        BH, D = 12, 64
        pairs = S * (S + 1) // 2
        b_ms, b_by = bound((4 * S * D + S) * BH * 4, 4 * pairs * D * BH)
        qh, kh, vh = (t.transpose(1, 2).contiguous() for t in qkv)
        shapes[S] = {
            "max_abs_err": e,
            "ms": time_ms(lambda: fa.flash_attention_with_lse(
                *qkv, causal=True), flush=flush),
            "plain_ms": time_ms(lambda: fa.flash_attention_reference(
                *qkv, causal=True), flush=flush),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                qh, kh, vh, is_causal=True), flush=flush)}
    big = shapes[1024]
    out["flash_attention_fwd"] = {
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "paddle_tpu_torch/kernels/csrc/flash_attention_fwd.cu",
        "replaces": "paddle_tpu/kernels/flash_attention.py:119",
        "max_abs_err": max(errs), "tolerance": KERNEL_TOL,
        "ms": big["ms"], "plain_ms": big["plain_ms"],
        "bound_ms": big["bound_ms"], "bound_by": big["bound_by"],
        "library_ms": big["library_ms"],
        "library": "scaled_dot_product_attention(is_causal=True)",
        "shape": {"B": 1, "H": 12, "D": 64, "S_timed": 1024},
        "per_S": {str(k): v for k, v in shapes.items()}}
    del flush
    torch.cuda.empty_cache()
    return out


# -- phase 3 -----------------------------------------------------------------

def _tf32_round(t):
    """Round float32 values to TF32's 10-bit mantissa (toward zero)."""
    return (t.contiguous().view(torch.int32) & -8192).view(torch.float32)


def _logit_checks(model, prompts, results, dev):
    """For two requests: logits of the kernel path (prefill_step, then one
    decode_step per generated token, through a fresh pool) against the
    plain full forward over prompt + generated tokens; the engine's
    greedy tokens and logprobs against the same forward; and the error a
    TF32 attention would make, which must exceed LOGIT_TOL."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.models import transformer as tt
    from paddle_tpu_torch.serving import PagePool, bucket_for, \
        padding_buckets, pages_for
    cfg = model.config
    p = model.params
    order = np.argsort([len(x) for x in prompts])
    picks = [int(order[0]), int(order[-1])]
    T = 16
    MB = pages_for(cfg.max_seq, T)
    pool = PagePool(2 * MB, T, *model.kv_spec)
    kp, vp = pool.zeros(dev)
    R = 4                                   # rows 2 and 3 stay inactive
    tables = np.full((R, MB), pool.trash_page, np.int32)
    tables[0] = np.arange(MB)
    tables[1] = np.arange(MB, 2 * MB)
    worst = {"prefill": 0.0, "decode": 0.0, "engine_logprob": 0.0,
             "tf32_attention": 0.0}
    fulls, last = [], []
    for row, j in enumerate(picks):
        seq = list(prompts[j]) + list(results[j].tokens)
        ids = torch.tensor([seq], dtype=torch.int32, device=dev)
        full = model(ids)[0]                                  # [N, V]
        fulls.append(full)
        n = len(prompts[j])
        padded = np.zeros((bucket_for(n, padding_buckets(cfg.max_seq)),),
                          np.int32)
        padded[:n] = prompts[j]
        got = tt.prefill_step(p, kp, vp, torch.from_numpy(padded).to(dev),
                              n, torch.from_numpy(tables[row]).to(dev), cfg)
        worst["prefill"] = max(worst["prefill"],
                               float((got - full[n - 1]).abs().max()))
        last.append(n)
        logp = torch.log_softmax(full, dim=-1)
        for t, tok in enumerate(results[j].tokens):
            row_l = full[n - 1 + t]
            if float(row_l.max() - row_l[tok]) > LOGIT_TOL:
                fail("engine token %d of request %d is not the plain "
                     "forward's argmax" % (t, j))
            worst["engine_logprob"] = max(
                worst["engine_logprob"],
                abs(results[j].logprobs[t] - float(logp[n - 1 + t, tok])))

        def tf32_attention(q, k, v):
            return fa.flash_attention_reference(
                _tf32_round(q), _tf32_round(k), _tf32_round(v),
                causal=True)[0]

        x, _, _ = tt._forward_hidden(p, ids, cfg, tf32_attention)
        worst["tf32_attention"] = max(
            worst["tf32_attention"],
            float(((x[0] @ p["lm_head"]) - full).abs().max()))
    steps = len(results[picks[0]].tokens) - 1
    for t in range(steps):
        toks = np.zeros((R,), np.int32)
        pos = np.zeros((R,), np.int32)
        active = np.zeros((R,), bool)
        for row, j in enumerate(picks):
            toks[row] = results[j].tokens[t]
            pos[row] = last[row] + t
            active[row] = True
        logits = tt.decode_step(
            p, kp, vp, torch.from_numpy(tables).to(dev),
            torch.from_numpy(pos).to(dev), torch.from_numpy(toks).to(dev),
            torch.from_numpy(active).to(dev), cfg)
        for row in range(2):
            worst["decode"] = max(worst["decode"], float(
                (logits[row] - fulls[row][pos[row]]).abs().max()))
    torch.cuda.synchronize()
    for key in ("prefill", "decode", "engine_logprob"):
        if not np.isfinite(worst[key]) or worst[key] > LOGIT_TOL:
            fail("%s logits differ from the plain forward by %g > %g"
                 % (key, worst[key], LOGIT_TOL))
    if not worst["tf32_attention"] > LOGIT_TOL:
        fail("a TF32 attention errs by only %g <= LOGIT_TOL %g: the "
             "tolerance is too loose to tell float32 from TF32"
             % (worst["tf32_attention"], LOGIT_TOL))
    return {"requests": picks, "decode_steps_checked": steps,
            "max_abs_err": worst, "tolerance": LOGIT_TOL}


def _profile_window(engine, prompts):
    """Drive the same requests again under torch.profiler: device kernel
    time by name and its share of the window's wall time (the profiler's
    own host overhead makes the window longer than an unprofiled one)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        handles = [engine.submit(pr, max_new_tokens=32) for pr in prompts]
        again = [h.wait(timeout=600) for h in handles]
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    kern = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t_us = getattr(e, "self_device_time_total", None)
        if t_us is None:
            t_us = e.self_cuda_time_total
        kern[e.key] = (t_us / 1e3, e.count)
    busy = sum(t for t, _ in kern.values())
    top = sorted(kern.items(), key=lambda kv: -kv[1][0])[:12]
    return again, {
        "window_wall_ms": wall * 1e3, "device_kernel_ms": busy,
        "device_busy_share": busy / (wall * 1e3),
        "top_kernels": [{"name": k[:120], "ms": t, "count": c}
                        for k, (t, c) in top]}


def phase_engine(dev, art_dir):
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.inference import export_generative, \
        load_generative
    from paddle_tpu_torch.models import transformer as tt
    from paddle_tpu_torch.serving import GenerationEngine
    cfg = tt.TransformerConfig(**GPT2_SMALL)
    t0 = time.monotonic()
    export_generative(art_dir, cfg, tt.init_params(cfg, seed=0))
    model = load_generative(art_dir, device=dev)
    setup_s = time.monotonic() - t0
    rng = np.random.RandomState(1)
    lengths = rng.randint(16, 901, 16)
    prompts = [list(rng.randint(0, cfg.vocab_size, n)) for n in lengths]
    engine = GenerationEngine(model, max_running=16, kv_pages=16 * 1024 // 16,
                              page_tokens=16, queue_depth=64, warm=True,
                              name="gpt2")
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        kernels.reset_launches()
        t0 = time.monotonic()
        handles = [engine.submit(pr, max_new_tokens=32) for pr in prompts]
        results = [h.wait(timeout=600) for h in handles]
        wall = time.monotonic() - t0
        launches = kernels.launch_counts()
        st = engine.stats
        again, profile = _profile_window(engine, prompts)
    finally:
        engine.close()
    profile["repeat_tokens_identical"] = \
        [r.tokens for r in again] == [r.tokens for r in results]
    profile["device_busy_share_of_unprofiled_wall"] = \
        profile["device_kernel_ms"] / (wall * 1e3)
    for r in results:
        if len(r.tokens) != 32 or r.finish_reason != "length":
            fail("a request ended with %d tokens (%s)"
                 % (len(r.tokens), r.finish_reason))
        if not all(0 <= t < cfg.vocab_size for t in r.tokens):
            fail("a token id out of the vocabulary")
    L = cfg.num_layers
    want = {"flash_attention_fwd": L * st["prefills"],
            "paged_attention": L * st["decode_steps"]}
    if launches != want or st["prefills"] < 16 or st["decode_steps"] < 31:
        fail("launch counts %s, expected %s (prefills %d, decode steps %d)"
             % (launches, want, st["prefills"], st["decode_steps"]))
    checks = _logit_checks(model, prompts, results, dev)
    tokens = sum(len(r.tokens) for r in results)
    metrics = {
        "config": dict(GPT2_SMALL, dtype="float32", seed=0),
        "requests": len(prompts), "prompt_tokens": int(lengths.sum()),
        "prompt_len_min": int(lengths.min()),
        "prompt_len_max": int(lengths.max()),
        "new_tokens_each": 32, "max_running": 16, "page_tokens": 16,
        "kv_pages": 1024, "setup_s": setup_s, "warmup_ms": engine.warmup_ms,
        "wall_s": wall, "tokens_per_s": tokens / wall,
        "engine_busy_s": st["busy_s"],
        "intertoken_ms_p50": st["intertoken_ms_p50"],
        "intertoken_ms_p99": st["intertoken_ms_p99"],
        "ttft_ms_p50": st["ttft_ms_p50"], "ttft_ms_p99": st["ttft_ms_p99"],
        "prefills": st["prefills"], "decode_steps": st["decode_steps"],
        "peak_memory_bytes": torch.cuda.max_memory_allocated(dev),
        "launches": launches, "logit_checks": checks, "profile": profile}
    log(json.dumps({"engine": metrics}))
    del model
    torch.cuda.empty_cache()
    return prompts, results, launches


# -- phase 4 -----------------------------------------------------------------

def _post(base, body, timeout=600):
    req = urllib.request.Request(
        base + "/v1/models/gpt2:generate", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def phase_http(dev, art_dir, prompts, results):
    from paddle_tpu_torch.serving import InferenceService, make_server, \
        serve_until_shutdown
    service = InferenceService()
    service.load_model("gpt2", art_dir, device=dev, max_running=16,
                       kv_pages=1024, page_tokens=16)
    server = make_server(service, host="127.0.0.1", port=0)
    base = "http://127.0.0.1:%d" % server.server_address[1]
    outcome = {"errors": []}
    in_flight = {}

    def inflight_post():
        try:
            in_flight["answer"] = _post(
                base, {"tokens": [int(t) for t in prompts[2]],
                       "max_new_tokens": 32})
        except Exception as e:          # reported by the main thread
            in_flight["error"] = repr(e)

    def client():
        try:
            for j in (0, 1):
                code, out = _post(base, {"tokens": [int(t) for t in
                                                    prompts[j]],
                                         "max_new_tokens": 32})
                if code != 200 or out["tokens"] != results[j].tokens:
                    outcome["errors"].append(
                        "POST %d answered %d with tokens that differ from "
                        "the engine's" % (j, code))
            t = threading.Thread(target=inflight_post, daemon=True)
            t.start()
            in_flight["thread"] = t
            deadline = time.monotonic() + 120
            while time.monotonic() < deadline and t.is_alive():
                st = service.stats["generation"]["gpt2"]
                if st["running"] or st["queued"]:
                    break
                time.sleep(0.005)
            outcome["running_at_signal"] = \
                service.stats["generation"]["gpt2"]["running"]
        except Exception as e:          # reported by the main thread
            outcome["errors"].append(repr(e))
        finally:
            os.kill(os.getpid(), signal.SIGTERM)

    threading.Thread(target=client, daemon=True).start()
    signum = serve_until_shutdown(server)
    server.server_close()
    service.close()                     # drains the in-flight request
    t = in_flight.get("thread")
    if t is not None:
        t.join(timeout=600)
    if outcome["errors"]:
        fail("; ".join(outcome["errors"]))
    if signum != signal.SIGTERM:
        fail("the server stopped on %r, not SIGTERM" % (signum,))
    ans = in_flight.get("answer")
    if ans is None or ans[0] != 200 or \
            ans[1]["tokens"] != results[2].tokens:
        fail("the request in flight at SIGTERM was not drained: %r"
             % (in_flight.get("error") or ans,))
    log(json.dumps({"http": {"posts": 3, "signal": "SIGTERM",
                             "running_at_signal":
                                 outcome["running_at_signal"],
                             "drained_tokens": len(ans[1]["tokens"])}}))


def main():
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a card")
    import paddle_tpu_torch  # noqa: F401  (fails outside a checkout)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                    "matmul.allow_tf32":
                        torch.backends.cuda.matmul.allow_tf32,
                    "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32}))
    card = card_line()
    t_start = time.monotonic()
    phase_build()
    kernels = phase_kernels(dev)
    root = os.path.dirname(os.path.abspath(__file__))
    art_dir = os.path.join(root, "build", "chip_smoke", "gpt2_small_seed0")
    prompts, results, launches = phase_engine(dev, art_dir)
    phase_http(dev, art_dir, prompts, results)
    for name, entry in kernels.items():
        entry["launches"] = launches[name]
        entry["kernel_ms"] = entry["ms"]
    log(json.dumps({"seconds": round(time.monotonic() - t_start, 3)}))
    log(card)
    log(json.dumps({"kernels": list(kernels.values())}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
