"""Photon sharding over cards and processes (port of
``rsmcrt_tpu/parallel``)."""
