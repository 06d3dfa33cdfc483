"""Static proofs the port routes by (``lint/fx``: certifiers over aten
graphs)."""
