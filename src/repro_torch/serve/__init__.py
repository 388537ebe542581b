"""Serving layer: the batched prefill/decode engine (serve/engine.py) and
the session scheduler with executed KV migration (serve/scheduler.py).
Submodules are imported directly: the engine pulls the model stack, which
the scheduler does not need.  The scan-compiled serving replay
(``serve/replay.py`` in the JAX package) belongs to a later slice."""
