"""Serving layer (port of ``ibamr_tpu/serve/``).

``aot_cache`` hash-conses whole warm step callables, keyed on the
flight-recorder fingerprint of their scenario family: on the card an
entry holds a warm eager callable or a captured CUDA graph. The router,
load generator, autoscaler and capacity model of the reference's
serving layer are the next slice of the port.
"""
