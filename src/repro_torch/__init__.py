"""PyTorch/CUDA port of the SAGE serverless GPU system (``src/repro/`` is
the JAX reference it is held against). Imports torch and numpy only."""
