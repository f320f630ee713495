"""The MLA-MoE serving cell at small sizes on the CPU: found by name, correct
with the port as it is and not with the fp8 control or a planted fault,
its product count held to FlopCounterMode on the port's own calls, and
its readers on known span records."""

import math
import time
from types import SimpleNamespace

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode, register_flop_formula

from _tiny import AMAZON, TINY_CONFIG, TINY_TRAFFIC
from hidvae_tpu_torch.data.schemas import TokenizedSeqBatch
from hidvae_tpu_torch.utils import debug
from perfbench import control
from perfbench.harness import flops_mla_moe as flops
from perfbench.harness import runner
from perfbench.reference import mla_moe as ref

CELL = "moonlight_p5sports.serve_b256"
SEED = 2 ** 31 + 12345
MODEL = dict(hidden_size=64, num_hidden_layers=3, num_attention_heads=4, kv_lora_rank=16,
             qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16, intermediate_size=96,
             moe_intermediate_size=24, n_routed_experts=8, num_experts_per_tok=2,
             n_shared_experts=1, serve_dtype="fp32", e_score_correction_bias_sd=0.1)


def overrides(**model):
    return {"config": {**TINY_CONFIG, **AMAZON, **MODEL, **model},
            "traffic": {**TINY_TRAFFIC, "check_beam_users": 3}}


def kind():
    return runner.load_cell(CELL)[5]


def test_the_cell_is_found_by_name():
    bench, entry, cfg, traffic, limits, k = runner.load_cell(CELL)
    assert traffic["kind"] == "serve_pages_mla_moe" and set(limits) == {
        "ids_off", "score_gap", "best_gap", "route_off"}
    config = [c for c in bench["configs"] if c["name"] == entry["config"]][0]
    assert cfg["reduced"] == config["reduced"] == ["num_hidden_layers", "vocab_size"]
    params = sum(math.prod(s) for _, s, _ in ref.spec(cfg, *k.dims(cfg)))
    assert 4.1e9 < params < 4.3e9  # the published widths at 8 layers
    names = {m["name"] for m in bench["per_layer"] if CELL in m.get("workloads", [CELL])}
    assert {"serve.moe_span_ms", "serve.mla_span_ms", "serve.moe_roofline_pct",
            "serve.mfu", "serve.encode_span_ms"} <= names


# Moonlight-16B-A3B's published config.json
PUBLISHED = {
    "attention_bias": False, "ep_size": 1, "first_k_dense_replace": 1, "hidden_act": "silu",
    "hidden_size": 2048, "intermediate_size": 11264, "kv_lora_rank": 512,
    "max_position_embeddings": 8192, "model_type": "deepseek_v3", "moe_intermediate_size": 1408,
    "moe_layer_freq": 1, "n_group": 1, "n_routed_experts": 64, "n_shared_experts": 2,
    "norm_topk_prob": True, "num_attention_heads": 16, "num_experts_per_tok": 6,
    "num_hidden_layers": 27, "num_key_value_heads": 16, "num_nextn_predict_layers": 0,
    "q_lora_rank": None, "qk_nope_head_dim": 128, "qk_rope_head_dim": 64, "rms_norm_eps": 1e-05,
    "rope_theta": 50000, "routed_scaling_factor": 2.446, "scoring_func": "sigmoid",
    "seq_aux": True, "tie_word_embeddings": False, "topk_group": 1, "topk_method": "noaux_tc",
    "v_head_dim": 128, "vocab_size": 163840}


def test_config_file_holds_the_published_keys():
    """Every published key as published, but the two cut (depth and the
    text vocabulary), each named in `reduced`."""
    cfg = runner.load_cell(CELL)[2]
    assert cfg["reduced"] == ["num_hidden_layers", "vocab_size"]
    for key, value in PUBLISHED.items():
        assert (cfg[key] != value) if key in cfg["reduced"] else (cfg[key] == value), key
    assert cfg["num_hidden_layers"] == 8 and cfg["first_k_dense_replace"] == 1


@pytest.mark.parametrize("trace", [0, 1])
def test_run_is_correct(trace):
    run = runner.run_cell(CELL, SEED, 0.3, trace, "cpu", time.perf_counter(),
                          overrides=overrides())
    assert run.checks and runner.correct(run), run.checks
    assert run.counters["check.routed_tokens"] > 0 and run.attempted > 0
    assert 0.0 <= run.counters["check.beam_tie_max"] <= ref.BEAM_TIE
    if trace:
        assert {"serve.encode_ms", "serve.beam_ms", "serve.resolve_ms"} <= set(
            runner.per_layer_values(run, runner.benchmark()))


def test_control_fails():
    values = dict(control.control_values(CELL, 7, "cpu", overrides()))
    limits = runner.load_cell(CELL)[4]
    assert any(values[k] > limits[k] for k in limits), values


@pytest.mark.parametrize("fault", ["token", "half", "bias", "edge"])
def test_fault_fails(fault):
    run = runner.run_cell(CELL, 11, 0.3, 0, "cpu", time.perf_counter(),
                          overrides=overrides(), plant=kind().FAULTS[fault])
    assert not runner.correct(run), run.checks


@register_flop_formula(torch.ops.aten._grouped_mm)
def _grouped_mm_flops(a_shape, b_shape, *args, **kwargs):
    """A grouped product of [M, K] rows over [G, K, N] weights: 2 M K N."""
    return 2 * a_shape[0] * a_shape[1] * b_shape[-1]


def test_executed_count_matches_the_flop_counter():
    """A prefill over ragged contexts and the beam's decode steps of the
    port against `executed_prefill` / `executed_step`, the experts' grouped
    products counted as 2 M K N, and the needed count of the same work."""
    _, _, cfg, _, _, _ = runner.load_cell(CELL, overrides=overrides())
    k = kind()
    model = k.build_model(cfg, k.make_weights(cfg, 3, "cpu"), "cpu")
    kk, d, _, _ = k.dims(cfg)
    b, n, g = 3, 4, 5
    lengths = torch.tensor([4, 2, 3])
    mask = (torch.arange(n)[None] < lengths[:, None]).repeat_interleave(d, 1)
    tt = torch.arange(d, dtype=torch.int32)
    batch = TokenizedSeqBatch(torch.arange(b, dtype=torch.int32),
                              torch.where(mask, torch.randint(0, kk, (b, n * d)), -1).int(),
                              None, mask, tt.repeat(b, n), None)
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        prefix, ctx_mask = model.encode_context(batch)
    valid = int(ctx_mask.sum())
    assert fc.get_total_flops() == flops.executed_prefill(cfg, b, 1 + n * d, valid)
    cache = model.start_decode(prefix, ctx_mask, b * g)
    for pos in range(d):
        ids = torch.randint(0, kk, (b * g, 1), dtype=torch.int32)
        with torch.no_grad(), FlopCounterMode(display=False) as fc:
            model.decode_step(cache, pos, ids if pos else None)
        assert fc.get_total_flops() == flops.executed_step(cfg, b * g, 1 + n * d, pos), pos
    # the needed count: valid pairs and tokens only, each row's new token once
    t = [flops.context_tokens({**cfg, "max_seq_len": n}, x) for x in lengths.tolist()]
    layers, pair = cfg["num_hidden_layers"], flops.attention_pair(cfg)
    want = sum(x * flops.token_flops(cfg) + layers * pair * x * (x + 1) // 2 for x in t)
    want += sum(flops.BEAMS * (flops.token_flops(cfg) + layers * pair * (x + i + 1)
                               + 2 * cfg["hidden_size"] * kk) for x in t for i in range(d))
    assert flops.page_flops({**cfg, "max_seq_len": n}, lengths.tolist()) == want


def _span_run(moe_ms, counts):
    recs = []
    for request, ms in enumerate(moe_ms):
        root = len(recs)
        recs.append({"index": root, "name": "engine.recommend", "parent": None,
                     "request": request, "fields": {}, "stream_ms": 100.0,
                     "lead_gap_ms": None, "counts": counts})
        for name, t in (("model.moe", ms / 2), ("model.mla", 1.0), ("model.moe", ms / 2)):
            recs.append({"index": len(recs), "name": name, "parent": root,
                         "request": request, "fields": {}, "stream_ms": t,
                         "lead_gap_ms": None, "counts": {}})
    return recs


def test_moe_readers_on_known_records(monkeypatch):
    cfg = runner.load_cell(CELL)[2]
    counts = {"moe.tokens": 1000, "moe.routed_rows": 6000}
    monkeypatch.setattr(debug, "records", lambda: _span_run([4.0, 6.0, 8.0], counts))
    run = SimpleNamespace(trace_summary={"window_s": 1.0}, attempted=3, cfg=cfg,
                          device_name="NVIDIA H100 80GB HBM3")
    read = {m: runner.load_module(runner.PERFBENCH / "metrics" / f"{m}.py", m).read
            for m in ("serve.moe_span_ms", "serve.mla_span_ms", "serve.moe_roofline_pct")}
    assert read["serve.moe_span_ms"](run) == 6.0 and read["serve.mla_span_ms"](run) == 1.0
    bound = max(flops.moe_flops(cfg, 3000, 18000) / 989.4e12,
                6 * flops.moe_weight_bytes(cfg) / flops.HBM_BYTES_PER_S)
    assert read["serve.moe_roofline_pct"](run) == pytest.approx(100 * bound / 0.018)
    run.trace_summary = None  # no device trace: nothing to read
    assert all(r(run) is None for r in read.values())

