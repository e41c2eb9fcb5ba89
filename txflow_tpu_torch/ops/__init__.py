"""Device kernels: field and curve arithmetic, ed25519 verify, stake tally.

Each kernel is hand-written CUDA (``csrc/``) with a plain PyTorch version
beside it in the same module; ``_lib`` builds and launches the kernels."""
