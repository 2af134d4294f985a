"""Port-side measurement tools: the counterparts of the JAX package's
``tools/`` probes that hold a Pallas kernel."""
