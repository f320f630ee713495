"""Where the port's stage-2 training step spends its time on the card.

    python3 scripts/torch_train_profile.py [--attrib] [--device cpu]

Without --attrib: chip_smoke.py's train runs (short: 20 items, batch 256;
long: 2,401 tokens, batch 64, flash), STEPS steps on the host clock, then
REPEATS under torch.profiler: busy time, launches, time by kernel kind.

--attrib (counterpart of scripts/profile_attrib.py): (a) the forward loss,
(b) forward + backward, (c) the AdamW step at B 256, 20 items x 6 digits,
8 x 512, bf16, and the 64-user x 32-beam beam step, each with its FLOPs,
share of the H100's peak, bytes and bound, and a profile_trace window.
HIDVAE_PROFILE_SMOKE=1 shrinks the shapes. Prints one JSON object last."""

import argparse
import json
import os
import statistics
import sys
import time
from collections import defaultdict

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from hidvae_tpu_torch.data.schemas import TokenizedSeqBatch  # noqa: E402
from hidvae_tpu_torch.ops.prefix_search import build_prefix_index, build_prefix_tries  # noqa: E402
from hidvae_tpu_torch.train import transformer as trainer  # noqa: E402
from hidvae_tpu_torch.train.common import Optimizer  # noqa: E402
from hidvae_tpu_torch.utils.debug import profile_trace  # noqa: E402

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


# FlopCounterMode counts products (mm, bmm, the dense attention's einsums)
# and SDPA, not elementwise ops, softmax, gathers or custom kernels.
FLOPS_COUNTED = "matrix products only (FlopCounterMode)"


def counted(fn):
    """(FLOPs FlopCounterMode counts in one fn(), fn's result)."""
    with FlopCounterMode(display=False) as fc:
        out = fn()
    return fc.get_total_flops(), out


def tensor_bytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def program(name, fn, flops, n_bytes, device, iters, warmup, peak):
    """fn's ms a call (host clock, synchronized, after `warmup`) beside its
    FLOPs, share of `peak` (on the card) and the H100's bound for its FLOPs
    and bytes."""
    for _ in range(warmup):
        fn()
    chip_smoke.sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    chip_smoke.sync(device)
    t = (time.perf_counter() - t0) / iters
    t_ops, t_bytes = flops / peak * 1e3, n_bytes / chip_smoke.H100_BYTES_PER_S * 1e3
    card = device.type == "cuda"  # a CPU run's rate is no share of the card's peak
    rec = dict(ms=t * 1e3, flops=flops, achieved_tflops=flops / t / 1e12 if card else None,
               share_of_peak=flops / t / peak if card else None, bytes=n_bytes,
               bound_ms=max(t_ops, t_bytes),
               bound_by="operations" if t_ops >= t_bytes else "bytes")
    print(f"{name}: {json.dumps(rec)}", file=sys.stderr, flush=True)
    return rec


def attrib(device, smoke=False, iters=50, warmup=3, beam_iters=10, trace_dir=None):
    """The three programs and the beam step (module docstring)."""
    device = torch.device(device)
    B, N, D, K = (8, 5, 6, 32) if smoke else (256, 20, 6, 256)
    T, users = N * D, 8 if smoke else 64
    model = trainer.build_model(sem_id_dim=D, max_seq_len=N, vae_codebook_size=K,
                                attn_layers=2 if smoke else 8, dtype=torch.bfloat16,
                                seed=chip_smoke.SEED).to(device)
    rng = np.random.RandomState(0)

    def ints(high, shape):
        return torch.as_tensor(rng.randint(0, high, shape), dtype=torch.int32, device=device)

    batch = TokenizedSeqBatch(
        user_ids=ints(2000, (B,)), sem_ids=ints(K, (B, T)), sem_ids_fut=ints(K, (B, D)),
        seq_mask=torch.ones((B, T), dtype=torch.bool, device=device),
        token_type_ids=torch.arange(D, dtype=torch.int32, device=device).repeat(B, N),
        token_type_ids_fut=torch.arange(D, dtype=torch.int32, device=device).repeat(B, 1))
    opt = Optimizer(model.parameters(), 3e-4, 0.035)
    params = tensor_bytes(*model.parameters())
    inputs = tensor_bytes(*(v for v in vars(batch).values() if v is not None))
    step = iter(range(1 << 30))

    def gen():
        return trainer.step_generator(chip_smoke.SEED, next(step), device)

    def fwd():
        with torch.no_grad():
            return model(batch, gen()).loss

    def fwd_bwd():
        model.zero_grad(set_to_none=True)
        model(batch, gen()).loss.backward()

    def full():
        return trainer.train_step(model, opt, batch, gen())

    peak = chip_smoke.H100_BF16_FLOPS
    report = {"device": (torch.cuda.get_device_name(device) if device.type == "cuda"
                         else "cpu"), "shape": f"B={B} T={T} {2 if smoke else 8}x512 bf16",
              "n_params": sum(p.numel() for p in model.parameters()),
              "flops_counted": FLOPS_COUNTED,
              "bytes_counted": "parameters, AdamW moments and inputs read once, outputs "
                               "written once; activations are not reckoned"}
    # Bytes: the forward reads the params and batch; forward + backward also
    # writes a gradient a parameter; the step reads params, mu and nu and
    # writes all three (fp32).
    for name, fn, n_bytes in (("fwd", fwd, params + inputs), ("fwd+bwd", fwd_bwd,
                              2 * params + inputs), ("full_step", full, 6 * params + inputs)):
        report[name] = program(name, fn, counted(fn)[0], n_bytes, device, iters, warmup, peak)
    report["attribution_ms"] = {
        "forward": report["fwd"]["ms"],
        "backward": report["fwd+bwd"]["ms"] - report["fwd"]["ms"],
        "optimizer": report["full_step"]["ms"] - report["fwd+bwd"]["ms"]}

    # The beam step: `users` histories against a random corpus's index.
    corpus = torch.as_tensor(np.random.RandomState(1).randint(0, K, (500 if smoke else 12000, D)),
                             dtype=torch.int32, device=device)
    index = build_prefix_index(corpus)
    sorted_np = index.cpu().numpy()
    tries = {lvl: None if t is None else tuple(torch.from_numpy(a).to(device) for a in t)
             for lvl, t in build_prefix_tries(sorted_np, K).items()}
    caps = tuple(int(np.unique(sorted_np[:, :n], axis=0, return_counts=True)[1].max())
                 for n in range(1, D))
    rows = torch.arange(users, device=device) % B
    gb = batch.replace(**{k: getattr(batch, k)[rows] for k in (
        "user_ids", "sem_ids", "sem_ids_fut", "seq_mask", "token_type_ids",
        "token_type_ids_fut")})

    def beam():
        with torch.inference_mode():
            return model.generate_next_sem_id(gb, index, prefix_caps=caps,
                                              prefix_tries=tries).sem_ids

    flops, ids = counted(beam)
    extra = tensor_bytes(index, *(a for t in tries.values() if t is not None for a in t))
    rec = program(f"beam {users}", beam, flops, params + inputs * users // B + extra +
                  tensor_bytes(ids), device, beam_iters, 1, peak)
    report["beam"] = {users: dict(rec, users_per_sec=users / rec["ms"] * 1e3)}

    with profile_trace(trace_dir or os.path.join("profile_traces", "attrib"), True) as prof:
        for _ in range(3):
            full()
        chip_smoke.sync(device)
    report["trace"] = prof.trace_path
    return report


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--attrib", action="store_true")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    if args.device != "cpu" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this profile runs on the card (or --device cpu)")
    device = torch.device("cuda", 0) if args.device == "cuda" else torch.device(args.device)
    if args.attrib:
        smoke = os.environ.get("HIDVAE_PROFILE_SMOKE") == "1"
        out = attrib(device, smoke, iters=3 if smoke else 50)
    else:
        out = {"device": torch.cuda.get_device_name(0)}
        for name, max_seq_len, batch, _ in chip_smoke.TRAIN_RUNS:
            out[name] = profile_run(name, max_seq_len, batch, device)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
