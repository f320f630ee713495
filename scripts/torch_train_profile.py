"""Where the port's stage-2 training step and beam spend their time on
the card (counterpart of scripts/profile_attrib.py):

    python3 scripts/torch_train_profile.py --attrib [--device cpu]

Forward, forward + backward, the AdamW step (B 256, 20 items x 6 digits,
8 x 512, bf16) and a 64-user x 32-beam beam step: FLOPs, share of peak,
bytes, bound, a profile_trace window (HIDVAE_PROFILE_SMOKE=1: small).
Prints one JSON object last."""

import argparse
import json
import os
import sys
import time

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
    card = device.type == "cuda"  # a CPU run's rate is no share of the card's peak
    bound_ms, bound_by = chip_smoke.bound_ms(flops, n_bytes, peak)
    rec = dict(ms=t * 1e3, flops=flops, achieved_tflops=flops / t / 1e12 if card else None,
               share_of_peak=flops / t / peak if card else None, bytes=n_bytes,
               bound_ms=bound_ms, bound_by=bound_by)
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
    if not args.attrib:
        parser.error("--attrib is the one report")
    smoke = os.environ.get("HIDVAE_PROFILE_SMOKE") == "1"
    print(json.dumps(attrib(device, smoke, iters=3 if smoke else 50)), flush=True)


if __name__ == "__main__":
    main()
