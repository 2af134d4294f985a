"""The benchmark's plain reference: :mod:`.plainmc` walks photons; one
module per TOML ``geom_name`` (``sphere``, ``box``) gives its scene in
closed form through ``build(cfg)``."""
