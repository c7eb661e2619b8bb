"""Multigrid ops: plain PyTorch versions (``ref``), the CUDA kernels
(``kernels``), the per-op choice between them (``dispatch``) and the batch
of cycles (``vcycle_batch``)."""
