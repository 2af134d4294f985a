"""The benchmark of ``rsmcrt_tpu_torch`` (see ``README.md``).  It runs the
port and never the JAX package: nothing here imports ``jax`` or
``rsmcrt_tpu``."""
