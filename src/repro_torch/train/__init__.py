"""Training/serving substrate (counterpart of ``repro.train``): AdamW with
int8 gradient compression (``optimizer``), the microbatched train step
(``trainstep``), the serve step's prefill and decode factories and the
host-side ``RequestBalancer`` (``servestep``)."""
