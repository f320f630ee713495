"""Multi-GPU: the process-group mesh, the stage-2 tensor-parallel layout and
its collectives (counterpart of hidvae_tpu/parallel)."""
