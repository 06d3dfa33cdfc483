"""Backend helpers the config-driven fleet needs: model loading
(``backend.py``) and the config-to-options translators (``mpc_backend.py``).
The backends themselves (``OptimizationBackend``, ``create_backend``,
``JAXBackend`` and the rest) wait for the backends slice."""
