"""The MoE layers' share of their roofline over the traced pages: the
larger of the needed expert, shared-expert and router products
(harness/flops_mla_moe.py `moe_flops`, from the `moe.tokens` and
`moe.routed_rows` counters) over the dense bf16 peak and the held MoE
weights' bytes, read once a call (`moe_weight_bytes` times the `model.moe`
spans), over the HBM's bytes a second, against the summed stream time of
the `model.moe` spans, in percent. It reads the same work whatever
implements the experts."""

from perfbench.harness.flops_mla_moe import HBM_BYTES_PER_S, moe_flops, moe_weight_bytes
from perfbench.harness.peaks import peaks_for
from perfbench.metrics._spans import requests, stream_ms


def read(run):
    reqs = requests(run, "engine.recommend")
    peaks = peaks_for(run.device_name)
    if reqs is None or peaks is None:
        return None
    times = [stream_ms(children, {"model.moe"}) for _, children in reqs]
    if not times or any(t is None for t in times):
        return None
    tokens = sum(r["counts"].get("moe.tokens", 0) for r, _ in reqs)
    rows = sum(r["counts"].get("moe.routed_rows", 0) for r, _ in reqs)
    calls = sum(sum(c["name"] == "model.moe" for c in children) for _, children in reqs)
    if not tokens:
        return None
    bound = max(moe_flops(run.cfg, tokens, rows) / peaks["bf16_flops"],
                calls * moe_weight_bytes(run.cfg) / HBM_BYTES_PER_S)
    return 100.0 * bound / (sum(times) / 1e3)
