"""Training/serving substrate (counterpart of ``repro.train``): so far the
host-side ``RequestBalancer`` of the serve step."""
