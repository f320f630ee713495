"""The later phases of chip_smoke.py at tiny widths in a subprocess that
refuses JAX and the JAX package at import (tests/test_torch_port_hygiene.py
runs the earlier ones): mining, rqvae, synthetic and scale."""

from tests.test_torch_port_hygiene import run_without_jax

PHASES_SCRIPT = """
    # The mining phase (L 4, the xxl_m gin's other keys kept, bf16): planted
    # copies collide; the pool refreshes at each audit and survives a resume.
    with tempfile.TemporaryDirectory() as work:
        tiny_xxl = dict(input_dim=48, hidden_dims=(32, 16), embed_dim=8, codebook_size=16,
                        n_layers=4, tag_embed_dim=12, tag_tree=(4, 3, 3), n_items=600)
        rec = chip_smoke.mining_phase(torch.device("cpu"), work, cfg=tiny_xxl, n=2,
                                      settings=(("mining", 32, 1),), timed=(1, 1),
                                      batch_size=32, sem_id_mining_pool=64, rare_tag_threshold=3)
    assert rec["resume_gaps"] == {"params": 0.0, "batch_stats": 0.0, "mu": 0.0, "nu": 0.0}, rec
    assert rec["collision_rate"][-1] > 0 and rec["pool_colliding"] == 1.0, rec

    # The rqvae phase: entry script, resume, audit table, served checkpoint.
    with tempfile.TemporaryDirectory() as work:
        rec = chip_smoke.rqvae_phase(torch.device("cpu"), work, cfg=dict(tiny_plain, n_items=400),
                                     n=2, timed=(1, 1), batch_size=16)
    assert rec["resume_gaps"] == {"params": 0.0, "mu": 0.0, "nu": 0.0}, rec
    # The synthetic phase (`large`, shrunk); scale at 2,000 items.
    with tempfile.TemporaryDirectory() as work:
        rec = chip_smoke.synthetic_phase(
            torch.device("cpu"), work, steps=2,
            corpus=dict(n_items=600, n_users=60, feature_dim=48, tag_dim=12),
            vae_input_dim=48, vae_hidden_dims=[32, 16], vae_embed_dim=8, vae_codebook_size=16,
            tag_embed_dim=12, batch_size=32, rare_tag_threshold=3)
    assert rec == {"run": 0, "table": 0}, rec
    recs = chip_smoke.scale_phase(torch.device("cpu"), sizes=(2000,), request_users=8, big=8,
                                  knee_buckets=[4, 8], decoder=dict(
                                      embedding_dim=16, attn_dim=32, num_heads=2, n_layers=1))
    assert recs[0]["top10_resolved_frac"] == 1.0, recs
"""


def test_later_phases_run_without_jax():
    run_without_jax(PHASES_SCRIPT)
