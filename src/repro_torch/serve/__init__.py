"""Serving layer: the batched prefill/decode engine (serve/engine.py), the
session scheduler with executed KV migration (serve/scheduler.py) and the
serving fleet replay (serve/replay.py).  Submodules are imported
directly: the engine pulls the model stack, which the scheduler and the
replay do not need."""
