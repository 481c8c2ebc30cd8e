"""Plain PyTorch lattice-Boltzmann ops (counterparts of openlbmpm_tpu.ops)."""
