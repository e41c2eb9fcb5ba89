"""txflow-tpu ported to PyTorch and CUDA on NVIDIA H100s (one card, or
several driven from one process).

The same per-transaction commit fast path as ``txflow_tpu`` (signed
TxVotes -> batched ed25519 verify + stake tally -> commit at 2/3 of
stake), with the device kernels written by hand for Hopper (``csrc/``).
This package imports neither JAX nor ``txflow_tpu``: it carries its own
copies of the host code it needs.
"""
