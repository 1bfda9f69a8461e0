"""Serving layer (port of ``ibamr_tpu/serve/``).

``aot_cache`` hash-conses whole warm step callables, keyed on the
flight-recorder fingerprint of their scenario family: on the card an
entry holds a warm eager callable or a captured CUDA graph, and a warm
pool's entries carry the device bytes the pool pins. ``router`` packs
scenario requests into warm fleet-lane buckets on top of it;
``loadgen`` drives the router with deterministic open-loop traffic;
``autoscale`` closes the loop from observed traffic to warm capacity
(elastic pools, brownout degradation, crash-safe restart) and
``capacity`` predicts what that loop can sustain.
"""
