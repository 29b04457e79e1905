"""Training/serving substrate (counterpart of ``repro.train``): so far the
serve step, its prefill and decode factories and the host-side
``RequestBalancer``."""
