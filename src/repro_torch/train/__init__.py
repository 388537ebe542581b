"""Training runtime pieces (counterpart of ``repro.train``): so far the
supervised restart loop, heartbeats and the straggler balancer
(:mod:`.fault_tolerance`)."""
