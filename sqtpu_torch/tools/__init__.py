"""Measurement and probe tools of the port, run as modules
(``python -m sqtpu_torch.tools.<name>``): counterparts of the JAX
package's ``tools/roofline_explicit.py``, ``tools/serve_bench.py`` and
``tools/probe_keras2019.py``. Each runs on ``cuda`` unless ``--device cpu``
is passed."""
