#!/usr/bin/env python3
"""Where a fresh process's first training step spends its time, on one
NVIDIA card: the host cost a step deadline (``FLAGS.step_timeout_s``)
would count if ``Trainer.train`` did not pay it before arming. Run from
the root of a checkout, once per fresh process:

    python3 tools/torch_first_step.py [--prewarm]

It builds the fit_a_line config's Trainer on ``cuda``, runs the startup
program, and times each batch of one pass through ``Executor.run`` (the
feed and the run, the card synchronized after each), the first under
``cProfile``; ``--prewarm`` first creates the cuBLAS handle and runs one
small product. Prints one JSON line (seconds: ``import_torch_s``,
``init_s``, ``prewarm_s``, ``steps``) and the profile's 30 costliest
calls by cumulative time.
"""
import argparse
import cProfile
import io
import json
import os
import pstats
import sys
import time


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--prewarm", action="store_true")
    args = ap.parse_args()
    t0 = time.perf_counter()
    import torch
    sys.path.insert(0, os.getcwd())
    out = {"import_torch_s": time.perf_counter() - t0,
           "prewarm": args.prewarm}
    if not torch.cuda.is_available():
        sys.exit("tools/torch_first_step.py: needs a CUDA device")
    from paddle_tpu_torch.configs import fit_a_line
    from paddle_tpu_torch.core import ir, unique_name
    from paddle_tpu_torch.trainer import Trainer
    main_prog, start = ir.Program(), ir.Program()
    with unique_name.guard(), ir.program_guard(main_prog, start):
        spec = fit_a_line.model()
        tr = Trainer(spec["cost"], spec["optimizer"], spec["feed_list"],
                     device="cuda", main_program=main_prog,
                     startup_program=start)
    t = time.perf_counter()
    tr._maybe_init()
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t
    if args.prewarm:
        t = time.perf_counter()
        torch.cuda.current_blas_handle()
        a = torch.ones(16, 13, device="cuda")
        b = torch.ones(13, 1, device="cuda")
        (a @ b).sum().item()
        out["prewarm_s"] = time.perf_counter() - t
    steps, report = [], ""
    for i, data in enumerate(spec["reader"]()):
        t = time.perf_counter()
        feed = tr.feeder.feed(data)
        feed_s = time.perf_counter() - t
        prof = cProfile.Profile() if i == 0 else None
        if prof is not None:
            prof.enable()
        tr.exe.run(tr.main_program, feed=feed, fetch_list=tr.fetch_list)
        torch.cuda.synchronize()
        if prof is not None:
            prof.disable()
            buf = io.StringIO()
            pstats.Stats(prof, stream=buf).sort_stats(
                "cumulative").print_stats(30)
            report = buf.getvalue()
        steps.append({"feed_s": feed_s, "total_s": time.perf_counter() - t})
    out["steps"] = steps
    out["card"] = torch.cuda.get_device_name(0)
    print(json.dumps(out))
    print(report)


if __name__ == "__main__":
    main()
