"""Where the port's stage-2 training step spends its time on the card.

    python3 scripts/torch_train_profile.py

For each run of chip_smoke.py's train phase (Amazon widths, seeded; short:
20 items, batch 256, dense; long: 2,401 tokens, batch 64, flash), after a
warm-up: STEPS steps on the host clock (each synchronized), then REPEATS
steps under torch.profiler: device busy time (union of kernel intervals),
launches, flash and matrix-product time and the top kernels per step. The
busy share is busy time over the unprofiled step. Prints one JSON object
last. Needs a CUDA device.
"""

import json
import os
import statistics
import sys
import time
from collections import defaultdict

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from hidvae_tpu_torch.train import transformer as trainer  # noqa: E402

WARMUP = 3
STEPS = 10
REPEATS = 3


def busy_ms(intervals):
    """Length of the union of [start, end) intervals (microseconds in, ms out)."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e3


def kind(name):
    """A kernel's share of the step: flash, matrix product (cuBLAS's gemm,
    xmma, nvjet and cutlass kernels) or the rest."""
    if "flash_" in name:
        return "flash"
    if any(tag in name.lower() for tag in ("gemm", "xmma", "nvjet", "cutlass")):
        return "matmul"
    return "other"


def profile_run(name, max_seq_len, batch, device):
    cfg = chip_smoke.AMAZON
    vae, feats = chip_smoke.build_vae(cfg, torch.Generator().manual_seed(chip_smoke.SEED))
    result, _, arrays = chip_smoke.train_run(cfg, vae, feats, device, max_seq_len, batch,
                                             WARMUP, log=lambda line: None)
    model, opt = result["model"], result["optimizer"]
    table = result["tokenizer"].cached_ids.to(torch.int32)
    data = trainer.as_seq_data(*arrays, device)

    def step(i):
        g = trainer.step_generator(chip_smoke.SEED, WARMUP + i, device)
        trainer.train_step(model, opt, trainer.sample_batch(data, table, batch, g), g)

    times = []
    for i in range(STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(i)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    step_ms = statistics.median(times)

    torch.cuda.reset_peak_memory_stats(device)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for i in range(REPEATS):
            step(STEPS + i)
        torch.cuda.synchronize()
    # Device-side events, less the user-annotation ranges (Optimizer.step#...)
    # that the profiler also puts on the device timeline.
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    by_name, by_kind = defaultdict(float), defaultdict(float)
    for e in kernels:
        ms = (e.time_range.end - e.time_range.start) / 1e3
        by_name[e.name] += ms
        by_kind[kind(e.name)] += ms
    busy = busy_ms([(e.time_range.start, e.time_range.end) for e in kernels]) / REPEATS
    print(f"{name}: {step_ms:.2f} ms/step (min {min(times):.2f}, max {max(times):.2f}), "
          f"device busy {busy:.2f} ms/step", flush=True)
    for kname, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        print(f"  {ms / REPEATS:9.3f} ms/step  {kind(kname):6s} {kname[:100]}", flush=True)
    return dict(
        max_seq_len=max_seq_len, batch=batch, step_ms=step_ms, step_ms_all=times,
        device_busy_ms=busy, device_busy_share=busy / step_ms,
        kernel_launches=len(kernels) / REPEATS,
        **{f"{k}_ms": v / REPEATS for k, v in by_kind.items()},
        flash_share_of_busy=by_kind["flash"] / REPEATS / busy,
        peak_memory_gb=torch.cuda.max_memory_allocated(device) / 1e9,
    )


def main():
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this profile runs on the card only")
    device = torch.device("cuda", 0)
    out = {"device": torch.cuda.get_device_name(0)}
    for name, max_seq_len, batch, _ in chip_smoke.TRAIN_RUNS:
        out[name] = profile_run(name, max_seq_len, batch, device)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
