"""Where the port's serve step spends its time on the card:

    python3 scripts/torch_serve_profile.py

chip_smoke.py's Amazon-width engine, REPEATS recommend calls of 32
histories traced (busy time, launches, top kernels) and one request's parts
timed on the host clock. Prints one JSON object last. Needs a card."""

import json
import os
import statistics
import sys
import time
from collections import defaultdict

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from hidvae_tpu_torch.ops.prefix_search import lookup_items  # noqa: E402
from hidvae_tpu_torch.train.device_data import tokenize_on_device  # noqa: E402
from hidvae_tpu_torch.utils.runtime import full_fp32  # noqa: E402

REPEATS = 5


def host_ms(fn, runs=10):
    fn()
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


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


def main():
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this profile runs on the card only")
    cfg = chip_smoke.AMAZON
    engine, _ = chip_smoke.build_engine(cfg, torch.device("cuda", 0))
    hist = chip_smoke.seeded_histories(cfg["n_items"], 32, cfg["max_seq_len"])
    for _ in range(3):
        engine.recommend(hist, top_k=10)
    torch.cuda.synchronize()

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(REPEATS):
            engine.recommend(hist, top_k=10)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = defaultdict(float)
    for e in kernels:
        by_name[e.name] += (e.time_range.end - e.time_range.start) / 1e3
    busy = busy_ms([(e.time_range.start, e.time_range.end) for e in kernels])
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]

    # Parts of one request, as RetrievalEngine._step runs them.
    dev = engine.device
    items = torch.from_numpy(engine._pad_histories(hist)).to(dev)
    uids = torch.zeros((items.shape[0],), dtype=torch.int32, device=dev)
    model, d = engine.model, engine.sem_id_dim

    def batch():
        b = tokenize_on_device(engine.corpus_ids, uids, items,
                               fut=torch.zeros_like(uids))
        return b.replace(sem_ids_fut=torch.zeros((items.shape[0], d), dtype=torch.int32,
                                                 device=dev))

    with torch.inference_mode(), full_fp32():
        b = batch()
        out = model.generate_next_sem_id(b, engine.sorted_ids, prefix_caps=engine.prefix_caps,
                                         prefix_tries=engine.prefix_tries)
        parts = {
            "tokenize_and_encoder_ms": host_ms(lambda: model.encode_context(batch())),
            "beam_search_constrained_ms": host_ms(lambda: model.generate_next_sem_id(
                b, engine.sorted_ids, prefix_caps=engine.prefix_caps,
                prefix_tries=engine.prefix_tries)),
            "beam_search_unconstrained_ms": host_ms(lambda: model.generate_next_sem_id(b)),
            "lookup_items_ms": host_ms(lambda: lookup_items(engine.sorted_ids, engine.perm,
                                                            out.sem_ids)),
            "recommend_ms": host_ms(lambda: engine.recommend(hist, top_k=10)),
        }
    for name, ms in top:
        print(f"  {ms / REPEATS:9.3f} ms/request  {name[:100]}", flush=True)
    result = dict(
        device=torch.cuda.get_device_name(0),
        wall_ms_per_request=wall_ms / REPEATS,
        device_busy_ms_per_request=busy / REPEATS,
        # The profiler slows the host, so the share of the profiled wall time
        # understates how busy the card is; the unprofiled recommend time is
        # the one a request takes.
        device_busy_share_under_profiler=busy / wall_ms,
        device_busy_share=busy / REPEATS / parts["recommend_ms"],
        device_ops_per_request=len(kernels) / REPEATS,
        **parts,
    )
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
